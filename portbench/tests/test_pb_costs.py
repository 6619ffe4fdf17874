"""The frozen cost model against the cell files: forwards an image, FLOPs
a forward (pinned at what the program's ``utils/flops.py`` gives), the
attention bound and the trace-based metrics' arithmetic."""

import pytest

from portbench import costmodel as C
from portbench.cells import load_cell, metric_reader
from portbench.reference.elastic import build_view_plan
from portbench.run import Run
from portbench.trace import Trace

# cell -> (views, UNet rows a step with repaint, rows an image)
CELLS = {"sdxl-2048sq": (16, 22 + 16 + 2 + 16, 430),
         "sd21-1024sq": (16, 16 + 16 + 2 + 16, 382),
         "sdxl-1024x2048": (4, 16 + 4 + 2 + 4, 202)}


def _views(cell):
    cfg, trf = cell.config, cell.traffic
    vsf = 2 ** (len(cfg["vae"]["block_out_channels"]) - 1)
    return build_view_plan(trf["height"] // vsf, trf["width"] // vsf,
                           cfg["unet"]["sample_size"], "cpu").num_views


@pytest.mark.parametrize("name", sorted(CELLS))
def test_forwards_per_image(name):
    cell = load_cell(name)
    views, per_step, per_image = CELLS[name]
    assert _views(cell) == views
    rs = cell.traffic["resampling_steps"]
    assert 2 * (rs + 1) + views + 2 + views == per_step
    assert C.image_costs(cell.config, cell.traffic, cell.steps, views)["unet_rows"] == per_image


@pytest.mark.parametrize("config,size,tflop", [("sdxl-2048sq", 128, 6.761),
                                               ("sd21-1024sq", 64, 0.804)])
def test_flops_per_forward_pinned(config, size, tflop):
    u = load_cell(config).config["unet"]
    assert C.unet_forward_flops(u, size, size) / 1e12 == pytest.approx(tflop, abs=5e-4)


def test_attention_bound_ops_or_bytes():
    self_4096 = C.AttnCall(4096, 4096, 640, 10, 1)
    cross = C.AttnCall(4096, 77, 640, 10, 1)
    ops = 4 * 4096 * 4096 * 640 / C.BF16_FLOPS
    nbytes = 2 * 640 * (2 * 4096 + 2 * 77) / C.HBM_BYTES_PER_S
    assert C.attention_bound_seconds([self_4096]) == pytest.approx(ops)
    assert C.attention_bound_seconds([cross]) == pytest.approx(nbytes)


def test_attention_calls_leave_out_the_small_mid_block():
    u = load_cell("sd21-1024sq").config["unet"]
    calls = C.unet_attention_calls(u, 64, 64)
    assert min(c.sq for c in calls) == 256 and len(calls) == 30


def test_trace_metrics_arithmetic():
    """idle_pct and attn_roofline from the traced window (three images);
    mfu_pct from the measured, untraced one (two images in 8 s)."""
    trace = Trace(window_s=10.0, busy_s=9.0,
                  kernels={"void flash_wgmma_bf16<64, 2, 128, 3>(x)": 0.5,
                           "void flash_wgmma_bf16_d512(x)": 9.0, "other": 1.0})
    run = Run(images=[{}, {}], window_s=8.0, setup_s=1.0, peak_bytes=1,
              costs={"unet_rows": 1, "flops": 989e12, "attn_bound_s": 0.1}, trace=trace,
              traced_images=3)
    assert metric_reader("idle_pct")(run) == pytest.approx(10.0)
    assert metric_reader("mfu_pct")(run) == pytest.approx(25.0)
    assert metric_reader("attn_roofline")(run) == pytest.approx(60.0)
    run.trace = None
    for m in ("idle_pct", "attn_roofline"):
        assert metric_reader(m)(run) is None
    assert metric_reader("mfu_pct")(run) == pytest.approx(25.0)
