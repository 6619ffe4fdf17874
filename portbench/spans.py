"""The port's own spans over a traced window: what the device did while the
host was in each of them.

The port records spans on the host's epoch clock when its tracer is set
(``elasticdiffusion_tpu_torch.utils.trace``: ``image``, ``preamble``,
``denoise``, ``step``, ``direction``, ``picks``, ``local``, ``undo``,
``unet``, ``decode``). ``torch.profiler``'s Kineto events carry the same
clock, so each idle stretch of the device and each launch the host makes
can be charged to the span the host was in. ``read`` takes the profiler's
events of one window (the ``trace.WINDOW`` range) and the spans that
overlap it, and gives:

  unet_launches     the host's CUDA launch calls (``LAUNCHES``: kernels,
                    graphs, copies, sets) that start inside a ``unet``
                    span, over the window's ``unet`` spans
  unet_idle_pct     the share of the window with no kernel, copy or set on
                    the device while the host's innermost span is a ``unet``
                    span (a ``unet`` span holds no other span)
  <phase>_peak_gib  the largest ``peak_bytes`` of the window's ``preamble``,
                    ``denoise`` or ``decode`` spans, in GiB
  idle_by_span      the window's idle seconds named by the innermost span
                    holding each idle stretch's start (``label``), top ten;
                    ``outside any image`` between images

Every reading is None, and ``idle_by_span`` empty, for a window without
spans: a port without the tracer, or a run that did not set it.
"""

from __future__ import annotations

import bisect
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from . import trace as tr

LAUNCHES = ("cudaLaunchKernel", "cuLaunchKernel", "cudaGraphLaunch",
            "cudaMemcpyAsync", "cudaMemsetAsync")
PHASES = ("preamble", "denoise", "decode")


def label(span, parent) -> str:
    """A span's name in ``idle_by_span``: a ``unet`` span with its parent
    and rows (``direction>unet[22]``), ``picks`` with its parent, the
    decode with its route (``decode[halo:monolithic]``)."""
    if span.name == "unet":
        return f"{parent.name if parent else ''}>unet[{span.attrs.get('rows')}]"
    if span.name == "picks":
        return f"{parent.name if parent else ''}>picks"
    if span.name == "decode" and "route" in span.attrs:
        return f"decode[{span.attrs['route']}]"
    return span.name


def window_and_busy(events) -> Tuple[Tuple[int, int], List[Tuple[int, int]]]:
    """The window range and the device's busy intervals inside it, merged
    (the reduction of ``trace.reduce``)."""
    cuda = torch.autograd.DeviceType.CUDA
    win, dev = None, []
    for ev in events:
        name = ev.name()
        if ev.device_type() == cuda:
            if not (ev.is_user_annotation() or name.startswith(("portbench.", tr.LAYER))):
                dev.append((ev.start_ns(), ev.end_ns()))
        elif name == tr.WINDOW:
            win = (ev.start_ns(), ev.end_ns())
    if win is None:
        raise RuntimeError("the profile holds no window range")
    w0, w1 = win
    return win, tr._merge([(max(s, w0), min(e, w1)) for s, e in dev
                           if min(e, w1) > max(s, w0)])


def idle_gaps(win, busy) -> List[Tuple[int, int]]:
    gaps, prev = [], win[0]
    for s, e in busy + [(win[1], win[1])]:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    return gaps


def _overlap(gaps: List[Tuple[int, int]], starts: List[int], a: int, b: int) -> int:
    """Nanoseconds of the sorted, disjoint `gaps` inside [a, b]."""
    i, out = max(bisect.bisect_right(starts, a) - 1, 0), 0
    while i < len(gaps) and gaps[i][0] < b:
        out += max(0, min(gaps[i][1], b) - max(gaps[i][0], a))
        i += 1
    return out


def launches(events) -> List[Tuple[int, int]]:
    """(start, end) of the host's launch calls (``LAUNCHES``), sorted; a
    call made inside another one on its thread (``cudaLaunchKernelExC``
    calling ``cuLaunchKernelEx``) is not a launch of its own."""
    calls = sorted((ev.start_ns(), ev.end_ns(), ev.start_thread_id()) for ev in events
                   if ev.device_type() != torch.autograd.DeviceType.CUDA
                   and ev.name().startswith(LAUNCHES))
    out, open_until = [], {}
    for s, e, thread in calls:
        if s < open_until.get(thread, s):
            continue
        out.append((s, e))
        open_until[thread] = e
    return out


def launch_counts(events, spans: Sequence) -> List[int]:
    """The launches (``launches``) that start inside each of `spans`, which
    are disjoint and sorted by start."""
    starts = [s.t0_ns for s in spans]
    counts = [0] * len(spans)
    for s, _ in launches(events):
        i = bisect.bisect_right(starts, s) - 1
        if i >= 0 and s <= spans[i].t1_ns:
            counts[i] += 1
    return counts


def read(events, spans: Sequence) -> Dict[str, object]:
    """The readings of one traced window (module docstring)."""
    events = list(events)
    win, busy = window_and_busy(events)
    w0, w1 = win
    spans = [s for s in spans if s.t1_ns is not None and s.t0_ns < w1 and s.t1_ns > w0]
    out: Dict[str, object] = {"unet_launches": None, "unet_idle_pct": None,
                              **{f"{p}_peak_gib": None for p in PHASES},
                              "idle_by_span": []}
    if not spans:
        return out
    by_id = {s.id: s for s in spans}
    gaps = idle_gaps(win, busy)
    gap_starts = [g[0] for g in gaps]

    unets = sorted((s for s in spans if s.name == "unet"), key=lambda s: s.t0_ns)
    if unets:
        out["unet_launches"] = sum(launch_counts(events, unets)) / len(unets)
        idle = sum(_overlap(gaps, gap_starts, s.t0_ns, s.t1_ns) for s in unets)
        out["unet_idle_pct"] = 100.0 * idle / (w1 - w0)

    for p, peak in phase_peaks(spans).items():
        if peak is not None:
            out[f"{p}_peak_gib"] = peak / 2 ** 30

    ranges = sorted((s.t0_ns, s.t1_ns, label(s, by_id.get(s.parent))) for s in spans)
    starts = [r[0] for r in ranges]
    named: Dict[str, float] = {}
    for g0, g1 in gaps:
        name = tr._host_label(ranges, starts, g0)
        named[name] = named.get(name, 0.0) + (g1 - g0) / 1e9
    out["idle_by_span"] = [[k, v] for k, v in sorted(named.items(),
                                                     key=lambda kv: -kv[1])[:tr.TOP]]
    return out


def phase_peaks(spans: Sequence) -> Dict[str, Optional[int]]:
    """The largest ``peak_bytes`` of each phase over `spans`, None where no
    span of that phase has one."""
    out = {}
    for p in PHASES:
        peaks = [s.attrs["peak_bytes"] for s in spans
                 if s.name == p and "peak_bytes" in s.attrs]
        out[p] = max(peaks) if peaks else None
    return out
