"""The end-to-end metrics' arithmetic, on synthetic numbers, and the step
clock and host probe that feed them."""

import numpy as np
import pytest

from portbench.cells import metric_reader
from portbench.host import Probe
from portbench.program import StepClock
from portbench.run import Run


def test_step_clock_marks_each_step_and_the_end():
    clock = StepClock(cuda=False)
    clock.marks = [0.0, 1.0, 2.5, 2.75]
    assert clock.durations() == [1.0, 1.5, 0.25]
    clock = StepClock(cuda=False)
    assert list(clock(range(3))) == [0, 1, 2]
    assert len(clock.marks) == 4 and len(clock.durations()) == 3


def test_host_probe_counts_gc_and_thread_time():
    import gc
    probe = Probe()
    junk = [[i] for i in range(20000)]
    gc.collect()
    got = probe.read()
    del junk
    assert got["gc_s"] > 0 and got["thread_cpu_s"] > 0
    assert set(got) == {"thread_cpu_s", "gc_s", "ctx_vol", "ctx_invol", "steal_s"}


def _run(images, window_s=20.0, peak=3 * 2 ** 30):
    return Run(images=images, window_s=window_s, setup_s=12.5, peak_bytes=peak,
               costs={"unet_rows": 10, "flops": 1e15, "attn_bound_s": 0.1})


def test_image_s_is_window_over_images():
    run = _run([{"steps_s": [1.0]}] * 4, window_s=20.0)
    assert metric_reader("image_s")(run) == 5.0


def test_step_p90_over_every_step_of_every_image():
    imgs = [{"steps_s": [0.1 * k for k in range(1, 11)]},
            {"steps_s": [0.1 * k for k in range(11, 21)]}]
    want = float(np.quantile([0.1 * k for k in range(1, 21)], 0.9))
    assert metric_reader("step_p90_s")(_run(imgs)) == pytest.approx(want)


def test_peak_and_setup():
    run = _run([{"steps_s": [1.0]}])
    assert metric_reader("peak_mem_gib")(run) == 3.0
    assert metric_reader("setup_s")(run) == 12.5


def test_program_span_metrics():
    m = lambda p, d, f, dec: {"metrics": {"preamble_seconds": p, "denoise_seconds": d,
                                          "unet_view_forwards": f,
                                          "decode_seconds": dec}, "steps_s": [d]}
    run = _run([m(0.2, 4.0, 10, 1.0), m(0.4, 6.0, 10, 2.0)])
    assert metric_reader("preamble_s")(run) == pytest.approx(0.3)
    assert metric_reader("decode_s")(run) == pytest.approx(1.5)
    assert metric_reader("fwd_per_s")(run) == pytest.approx(2.0)
    run.images[1]["metrics"]["unet_view_forwards"] = 11
    assert metric_reader("fwd_per_s")(run) is None

