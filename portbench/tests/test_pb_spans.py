"""The port's spans over a traced window (``spans.py``), on synthetic
Kineto events and spans: launches and idle charged to ``unet`` spans, the
phase peaks, idle named by the innermost span, and a window without spans."""

from types import SimpleNamespace

import pytest
import torch

from portbench import spans as sp
from portbench import trace as tr
from test_pb_trace import Ev as _Ev

CPU, GPU = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


class Ev(_Ev):
    def __init__(self, *a, thread=1, **k):
        super().__init__(*a, **k)
        self._t = thread

    def start_thread_id(self):
        return self._t


def Span(id, parent, name, t0, t1, **attrs):
    return SimpleNamespace(id=id, parent=parent, image=0, name=name, t0_ns=t0,
                           t1_ns=t1, attrs=attrs)


# window 0..1000; device busy 0-100, 300-350, 600-1000
EVENTS = [Ev(tr.WINDOW, CPU, 0, 1000, True),
          Ev("k1", GPU, 0, 100), Ev("k2", GPU, 300, 350), Ev("k3", GPU, 600, 1000),
          Ev(tr.WINDOW, GPU, 0, 1000, True),
          Ev("cudaLaunchKernel", CPU, 120, 121), Ev("cudaLaunchKernelExC", CPU, 130, 131),
          Ev("cuLaunchKernelEx", CPU, 140, 141), Ev("cudaMemcpyAsync", CPU, 150, 151),
          Ev("cudaGraphLaunch", CPU, 420, 421),
          Ev("cudaLaunchKernel", CPU, 50, 51),        # in the step, not in a unet
          Ev("cudaStreamSynchronize", CPU, 160, 161),  # not a launch
          Ev("aten::mm", CPU, 125, 126)]
SPANS = [Span(0, None, "image", 10, 990, B=1),
         Span(1, 0, "denoise", 20, 700, peak_bytes=3 * 2 ** 30),
         Span(2, 1, "step", 30, 690, i=0),
         Span(3, 2, "direction", 40, 260),
         Span(4, 3, "picks", 45, 110, n_sub=2),
         Span(5, 3, "unet", 110, 250, rows=22),
         Span(6, 2, "local", 400, 500),
         Span(7, 6, "unet", 410, 480, rows=16),
         Span(8, 0, "decode", 700, 980, route="halo:monolithic",
              peak_bytes=5 * 2 ** 30)]


def test_launches_count_only_runtime_calls_inside_unet_spans():
    r = sp.read(EVENTS, SPANS)
    assert r["unet_launches"] == pytest.approx(5 / 2)


def test_a_launch_call_nested_in_another_counts_once():
    nested = EVENTS + [Ev("cudaLaunchKernelExC", CPU, 200, 210),
                       Ev("cuLaunchKernelEx", CPU, 202, 208),
                       Ev("cuLaunchKernel", CPU, 204, 206, thread=2)]
    assert sp.read(nested, SPANS)["unet_launches"] == pytest.approx(7 / 2)


def test_unet_idle_counts_only_idle_inside_unet_spans():
    # idle 100-300 holds unet 110-250 (140 ns); idle 350-600 holds 410-480 (70)
    r = sp.read(EVENTS, SPANS)
    assert r["unet_idle_pct"] == pytest.approx(100 * 210 / 1000)


def test_phase_peaks_and_idle_by_innermost_span():
    r = sp.read(EVENTS, SPANS)
    assert r["denoise_peak_gib"] == 3.0 and r["decode_peak_gib"] == 5.0
    assert r["preamble_peak_gib"] is None
    assert dict(r["idle_by_span"]) == pytest.approx(
        {"direction>picks": 200e-9, "step": 250e-9})


def test_labels_name_parents_rows_and_routes():
    by_id = {s.id: s for s in SPANS}
    assert [sp.label(s, by_id.get(s.parent)) for s in SPANS] == [
        "image", "denoise", "step", "direction", "direction>picks",
        "direction>unet[22]", "local", "local>unet[16]",
        "decode[halo:monolithic]"]


def test_a_window_without_spans_reads_none_and_keeps_idle_gaps():
    before = tr.reduce(EVENTS)
    r = sp.read(EVENTS, [])
    assert all(r[k] is None for k in r if k != "idle_by_span")
    assert r["idle_by_span"] == []
    assert tr.reduce(EVENTS).idle_by_host == before.idle_by_host == {
        "outside any image": pytest.approx(450e-9)}


def test_spans_outside_the_window_are_left_out():
    late = [Span(20, None, "image", 2000, 3000), Span(21, 20, "unet", 2100, 2200, rows=2)]
    assert sp.read(EVENTS, late)["unet_launches"] is None
