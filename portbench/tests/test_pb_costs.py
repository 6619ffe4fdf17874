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
         "sdxl-1024x2048": (4, 16 + 4 + 2 + 4, 202),
         "sd21-1024sq-fp32": (16, 16 + 16 + 2 + 16, 382)}


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


@pytest.mark.parametrize("name,flops,bound_s", [
    ("sdxl-2048sq", 2955810291318784, 0.3839175809578195),
    ("sd21-1024sq", 317696743964672, 0.05377639666342905),
    ("sdxl-1024x2048", 1387810049228800, 0.1803519798918129)])
def test_the_bf16_cells_costs_are_unchanged(name, flops, bound_s):
    """What the cost model gave these cells before it counted ControlNets
    and float32 attention: 6.761 and 0.804 TFLOP a UNet row."""
    cell = load_cell(name)
    got = C.image_costs(cell.config, cell.traffic, cell.steps, _views(cell))
    assert got["flops"] == flops and got["attn_bound_s"] == bound_s


def test_a_controlnet_row_is_counted_beside_each_unet_row():
    """The published canny SDXL ControlNet: 3.020 TFLOP a row at 128 x 128
    (the UNet's trunk, the condition's embedding at 1024 x 1024 pixels and
    the zero convolutions), and its 68 attention calls of the kernel's
    size; image_costs adds both for every UNet row."""
    cell = load_cell("sdxl-1024x2048")
    cfg = cell.config
    cn = {**cfg["unet"], "conditioning_embedding_out_channels": [16, 32, 96, 256]}
    assert C.controlnet_forward_flops(cn, 128, 128) / 1e12 == pytest.approx(3.020, abs=5e-4)
    calls = C.controlnet_attention_calls(cn, 128, 128)
    assert sum(c.count for c in calls) == 68
    plain = C.image_costs(cfg, cell.traffic, cell.steps, 4)
    both = C.image_costs({**cfg, "controlnet": cn,
                          "dtypes": {**cfg["dtypes"], "controlnet": "bfloat16"}},
                         cell.traffic, cell.steps, 4)
    rows = plain["unet_rows"]
    assert both["flops"] - plain["flops"] == rows * C.controlnet_forward_flops(cn, 128, 128)
    assert both["attn_bound_s"] - plain["attn_bound_s"] == pytest.approx(
        rows * C.attention_bound_seconds(calls))


def test_fp32_attention_is_bound_by_the_3xtf32_floor_and_4_byte_elements():
    self_4096 = C.AttnCall(4096, 4096, 640, 10, 1)
    cross = C.AttnCall(4096, 77, 640, 10, 1)
    fp32 = C.ATTENTION_RATES["float32"]
    assert C.attention_bound_seconds([self_4096], *fp32) == pytest.approx(
        3 * 4 * 4096 * 4096 * 640 / 494.7e12)
    assert C.attention_bound_seconds([cross], *fp32) == pytest.approx(
        4 * 640 * (2 * 4096 + 2 * 77) / C.HBM_BYTES_PER_S)
    f, b = load_cell("sd21-1024sq-fp32"), load_cell("sd21-1024sq")
    cf = C.image_costs(f.config, f.traffic, f.steps, 16)
    cb = C.image_costs(b.config, b.traffic, b.steps, 16)
    assert cf["flops"] == cb["flops"]
    assert 5 < cf["attn_bound_s"] / cb["attn_bound_s"] < 6
