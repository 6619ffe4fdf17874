"""The cell ``sdxl-canny-1024x2048``: its configuration is SDXL's with the
published canny ControlNet block, which the harness takes unchanged and
whose weights are the port's by name and shape; its traffic is
``demo_1024x2048``'s with an edge map; its two readers read the program's
ControlNet counters on the toy ControlNet cell and nothing where the
images carry none (a cell without a ControlNet, or a program without the
counters)."""

import pytest
import torch

import toy
from portbench import program
from portbench.cells import load_cell, metric_reader
from portbench.reference import models as M
from portbench.run import Run, run_cell

CELL = "sdxl-canny-1024x2048"
READERS = ("cn_share_pct", "cn_row_ms")


def test_the_configuration_is_sdxls_with_the_published_controlnet():
    canny, sdxl = load_cell(CELL).config, load_cell("sdxl-1024x2048").config
    assert {k for k in sdxl if canny[k] != sdxl[k]} == {"name", "source", "deployment",
                                                        "dtypes"}
    assert set(canny) - set(sdxl) == {"controlnet"}
    assert canny["dtypes"] == {**sdxl["dtypes"], "controlnet": "bfloat16"}
    assert canny["reduced"] == ["num_inference_steps", "weights"]
    cn = canny["controlnet"]
    for k in ("block_out_channels", "down_block_types", "transformer_layers_per_block",
              "attention_head_dim", "cross_attention_dim", "addition_embed_type",
              "addition_time_embed_dim", "projection_class_embeddings_input_dim",
              "use_linear_projection", "layers_per_block"):
        assert cn[k] == sdxl["unet"][k], k
    assert cn["conditioning_embedding_out_channels"] == [16, 32, 96, 256]
    assert cn["kind"] == "canny"


def test_the_harness_takes_the_file_and_its_names_are_the_ports():
    from elasticdiffusion_tpu_torch.configs import ControlNetConfig
    from elasticdiffusion_tpu_torch.models.controlnet import ControlNet
    from elasticdiffusion_tpu_torch.models.convert import hf_to_port
    cfg = load_cell(CELL).config
    program.check_controlnet(cfg)
    program.runtime_config(cfg)
    with torch.device("meta"):
        theirs = ControlNet(ControlNetConfig(unet=program.bundle_config(cfg).unet,
                                             cond_downsample_factor=8)).state_dict()
        mine = hf_to_port(M.build("controlnet", cfg["controlnet"]).state_dict(), "controlnet")
    assert set(mine) == set(theirs)
    assert all(tuple(mine[k].shape) == tuple(theirs[k].shape) for k in mine)
    assert 1.2e9 < sum(t.numel() for t in mine.values()) < 1.3e9


def test_the_traffic_is_demo_1024x2048s_with_an_edge_map():
    canny, plain = load_cell(CELL).traffic, load_cell("sdxl-1024x2048").traffic
    assert {k for k in set(canny) | set(plain) if canny.get(k) != plain.get(k)} == {
        "source", "condition", "controlnet_conditioning_scale"}
    assert canny["condition"] == {"kind": "edges", "shapes": [12, 24], "line_px": 3}
    assert canny["controlnet_conditioning_scale"] == 0.5


@pytest.fixture(scope="module")
def toy_runs():
    """The readers' values on a run of the toy ControlNet cell and of the
    toy SDXL-like cell without one."""
    out = {}
    for kind in ("canny", "xl"):
        r = run_cell(toy.cell(kind), 77, 0.01, False, device="cpu", t0=0.0,
                     metric_names=list(READERS))
        out[kind] = {k: v["value"] for k, v in r["metrics"].items()}
    return out


@pytest.mark.parametrize("name", READERS)
def test_the_readers_read_the_toy_controlnet_cell(toy_runs, name):
    assert toy_runs["canny"][name] > 0
    assert name not in toy_runs["xl"]


def _run(metrics, rows=10):
    return Run(images=[{"metrics": m} for m in metrics], window_s=1.0, setup_s=0.0,
               peak_bytes=0, costs={"unet_rows": rows, "flops": 1.0, "attn_bound_s": 0.0})


@pytest.mark.parametrize("name,want", [("cn_share_pct", 100.0 * 3.0 / 8.0),
                                       ("cn_row_ms", 1000.0 * 3.0 / 20)])
def test_the_readers_sum_over_the_images(name, want):
    imgs = [{"controlnet_view_forwards": 10, "controlnet_device_seconds": s,
             "denoise_seconds": d} for s, d in ((1.0, 3.0), (2.0, 5.0))]
    assert metric_reader(name)(_run(imgs)) == pytest.approx(want)


@pytest.mark.parametrize("name", READERS)
def test_the_readers_read_nothing_without_a_right_count(name):
    """A program without the counters (the keys absent), and a count that
    is not the benchmark's own, read None."""
    read = metric_reader(name)
    assert read(_run([{"denoise_seconds": 1.0, "unet_view_forwards": 10}])) is None
    assert read(_run([{"controlnet_view_forwards": 9, "controlnet_device_seconds": 1.0,
                       "denoise_seconds": 2.0}])) is None
