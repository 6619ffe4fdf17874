"""The trace's reduction on synthetic kineto events: the window, the
device's busy union, kernel time by name, idle stretches named by the
innermost host range, and the layer wrappers."""

import pytest
import torch

from portbench import trace as tr

CPU, GPU = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


class Ev:
    def __init__(self, name, dev, start, end, annotation=False):
        self._n, self._d, self._s, self._e, self._a = name, dev, start, end, annotation

    def name(self):
        return self._n

    def device_type(self):
        return self._d

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._e

    def is_user_annotation(self):
        return self._a


def test_reduce_busy_idle_and_kernels():
    evs = [Ev(tr.WINDOW, CPU, 0, 1000, True), Ev(tr.IMAGE, CPU, 10, 990, True),
           Ev("layer:undo_step", CPU, 100, 300, True),
           Ev("k1", GPU, 0, 100), Ev("k2", GPU, 50, 120),
           Ev("void flash_wgmma_bf16<64, 2, 128, 3>(x)", GPU, 400, 900),
           Ev(tr.WINDOW, GPU, 0, 1000, True),      # the range's device shadow
           Ev("k3", GPU, 1500, 1600)]              # outside the window
    t = tr.reduce(evs)
    assert t.window_s == pytest.approx(1e-6)
    assert t.busy_s == pytest.approx(620e-9)
    assert t.kernel_seconds(["flash_wgmma_bf16<"]) == pytest.approx(500e-9)
    assert t.idle_by_host == pytest.approx({"undo_step": 280e-9,
                                            "image, outside the layers": 100e-9})
    b = t.breakdown()
    assert b["device_ops"][0][1] == pytest.approx(500e-9)
    assert len(b["device_ops"]) == 3 and b["idle_gaps"][0][0] == "undo_step"


def test_reduce_needs_the_window():
    with pytest.raises(RuntimeError):
        tr.reduce([Ev("k", GPU, 0, 1)])


def test_wrappers_wrap_and_unwrap_and_skip_missing():
    from elasticdiffusion_tpu_torch.core import signals
    from elasticdiffusion_tpu_torch.models.registry import ModelBundle
    orig_fn, orig_m = signals.undo_step, ModelBundle.__dict__["apply_unet"]
    unwrap = tr.wrap_layers(tr.LAYER_ENTRIES + (("elasticdiffusion_tpu_torch.core.signals",
                                                 "no_such_function"),
                                                ("no_such_module", "f")))
    try:
        assert signals.undo_step is not orig_fn
        assert ModelBundle.__dict__["apply_unet"] is not orig_m
        assert signals.undo_step.__wrapped__ is orig_fn
    finally:
        unwrap()
    assert signals.undo_step is orig_fn and ModelBundle.__dict__["apply_unet"] is orig_m
