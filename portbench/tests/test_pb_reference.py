"""The plain reference against the port at toy size on the CPU, and the
checkpoint names it makes against the port's modules at full size."""

import pytest
import torch

import toy
from portbench import check, program
from portbench import traffic as traffic_mod
from portbench import weights as wts
from portbench.cells import load_cell


def _record(cell, seed, runtime=None):
    pipe = program.build_pipe(cell.config, wts.make_weights(cell.config, seed, "cpu"),
                              "cpu", runtime=runtime)
    req = next(traffic_mod.requests(cell.traffic, seed))
    return {**req, **program.generate(pipe, cell.traffic, cell.steps, req)}


def test_the_later_step_covers_every_step_after_the_first():
    drawn = [check.checked_steps(8, s)["later_step"] for s in range(2 ** 31, 2 ** 31 + 200)]
    assert set(drawn) == set(range(1, 8))
    assert check.checked_steps(8, 2 ** 33 + 5) == check.checked_steps(8, 2 ** 33 + 5)


@pytest.mark.parametrize("later", [1, 2])
@pytest.mark.parametrize("kind", ["sd2", "xl"])
def test_reference_follows_the_port_in_fp32(monkeypatch, kind, later):
    """With the port in float32 the two differ by rounding alone: the same
    algorithm, random draws and weights, at step 0 and at each later step
    (the toy's 3 steps, with a cosine scale of 1 so that the guidance
    lasts: step 1 repaints and guides, step 2 does neither)."""
    from elasticdiffusion_tpu_torch.configs import RuntimeConfig
    monkeypatch.setattr(check, "checked_steps",
                        lambda steps, seed: {"first_step": 0, "later_step": later})
    cell = toy.cell(kind)
    cell.traffic["cosine_scale"] = 1.0
    rec = _record(cell, 5, RuntimeConfig(param_dtype=torch.float32,
                                         compute_dtype=torch.float32))
    ref = check.reference_outputs(cell.config, cell.traffic, cell.steps,
                                  wts.make_weights(cell.config, 5, "cpu"), rec, "cpu")
    unit = check.reference_outputs(cell.config, cell.traffic, cell.steps,
                                   wts.make_weights(cell.config, 5, "cpu"), rec,
                                   "cpu", mode="unit", decode=False)
    got = check.program_readings(rec, ref, unit)
    # steps in units of bf16 rounding's effect (a sound bf16 program: ~2)
    assert got["first_step"] < 0.01 and got["later_step"] < 0.01, got
    assert got["decode"] < 1e-5, got


@pytest.mark.parametrize("kind", ["sd2", "xl"])
def test_weights_are_the_same_from_one_seed(kind):
    cfg = toy.cell(kind).config
    a, b = wts.make_weights(cfg, 9, "cpu"), wts.make_weights(cfg, 9, "cpu")
    c = wts.make_weights(cfg, 10, "cpu")
    for name in a:
        assert all(torch.equal(a[name][k], b[name][k]) for k in a[name])
    assert not torch.equal(a["unet"]["conv_in.weight"], c["unet"]["conv_in.weight"])
    assert a["unet"]["conv_in.weight"].dtype == torch.bfloat16
    assert a["vae"]["decoder.conv_in.weight"].dtype == torch.float32


@pytest.mark.parametrize("cell", ["sdxl-2048sq", "sd21-1024sq"])
def test_checkpoint_names_are_the_ports_at_full_size(cell):
    """Every name and shape the benchmark makes is a parameter of the
    port's model, and none is missing (the port's loader is strict)."""
    from elasticdiffusion_tpu_torch.models.clip import CLIPTextModel
    from elasticdiffusion_tpu_torch.models.convert import hf_to_port
    from elasticdiffusion_tpu_torch.models.unet import UNet2DCondition
    from elasticdiffusion_tpu_torch.models.vae import AutoencoderKL
    cfg = load_cell(cell).config
    bc = program.bundle_config(cfg)
    with torch.device("meta"):
        port = {"unet": (UNet2DCondition(bc.unet), "unet"),
                "vae": (AutoencoderKL(bc.vae), "vae"),
                "text_encoder": (CLIPTextModel(bc.text_encoders[0]), "clip")}
        if len(bc.text_encoders) > 1:
            port["text_encoder_2"] = (CLIPTextModel(bc.text_encoders[1]), "clip")
    ours = wts.checkpoint_models(cfg)
    assert set(ours) == set(port)
    for name, (model, kind) in port.items():
        mine = hf_to_port({k: v for k, v in ours[name].state_dict().items()}, kind)
        theirs = model.state_dict()
        assert set(mine) == set(theirs), name
        assert all(tuple(mine[k].shape) == tuple(theirs[k].shape) for k in mine), name


@pytest.mark.parametrize("name", ["sdxl", "sd21"])
def test_the_runtime_of_the_bf16_configurations_is_the_default(name):
    from elasticdiffusion_tpu_torch.configs import RuntimeConfig
    cfg = load_cell({"sdxl": "sdxl-2048sq", "sd21": "sd21-1024sq"}[name]).config
    assert program.runtime_config(cfg) == RuntimeConfig()


def test_the_fp32_configuration_runs_as_the_clis_fp32():
    from elasticdiffusion_tpu_torch.configs import RuntimeConfig
    cfg = load_cell("sd21-1024sq-fp32").config
    rt = program.runtime_config(cfg)
    assert rt == RuntimeConfig(param_dtype=torch.float32, compute_dtype=torch.float32)
    assert program.runtime_config({**cfg, "runtime": {"conv_impl": "kernel"}}).conv_impl == "kernel"
    for dtypes in ({**cfg["dtypes"], "text_encoder": "bfloat16"},
                   {**cfg["dtypes"], "vae_decode": "bfloat16"}):
        with pytest.raises(ValueError):
            program.runtime_config({**cfg, "dtypes": dtypes})
    with pytest.raises(ValueError):
        program.runtime_config({**cfg, "runtime": {"use_kernels": "off"}})


def _with_controlnet(cfg):
    return {**cfg, "controlnet": {**cfg["unet"], "kind": "canny",
                                  "conditioning_embedding_out_channels": [96, 256]},
            "dtypes": {**cfg["dtypes"], "controlnet": "bfloat16"}}


@pytest.mark.parametrize("kind", ["sd2", "xl"])
def test_weights_are_the_same_bits_with_a_controlnet_after_them(kind):
    cfg = toy.cell(kind).config
    a, b = wts.make_weights(cfg, 9, "cpu"), wts.make_weights(_with_controlnet(cfg), 9, "cpu")
    assert list(b) == list(a) + ["controlnet"]
    for name in a:
        assert list(a[name]) == list(b[name])
        assert all(torch.equal(a[name][k], b[name][k]) for k in a[name]), name


@pytest.mark.parametrize("cell", ["sdxl-2048sq", "sd21-1024sq"])
def test_a_controlnet_is_drawn_after_the_published_models(cell):
    """At full size (on the meta device): the other models are drawn in the
    same order and shapes with a ControlNet block as without, so from the
    same sub-seeds and offsets."""
    cfg = load_cell(cell).config
    a = wts.checkpoint_models(cfg)
    b = wts.checkpoint_models({**cfg, "controlnet": {**cfg["unet"], **toy.CANNY_SDXL}})
    assert list(b) == list(a) + ["controlnet"]
    for name in a:
        sa, sb = a[name].state_dict(), b[name].state_dict()
        assert [(k, v.shape) for k, v in sa.items()] == [(k, v.shape) for k, v in sb.items()]


def test_the_fp32_unit_is_tf32_and_not_zero():
    """A float32 UNet's steps are in units of TF32 (on the CPU, inputs
    rounded to 10 mantissa bits), which moves a step; bf16 configurations
    keep bf16 rounding where they state bfloat16 and float32 elsewhere."""
    fp32 = toy.cell("fp32")
    assert {p.mode for p in check.precisions(fp32.config, "unit").values()} == {"tf32"}
    xl = check.precisions(toy.cell("xl").config, "unit")
    assert xl["unet"].mode == "bf16" and xl["vae_decode"].mode == "fp32"
    rec = _record(fp32, 6)
    w = wts.make_weights(fp32.config, 6, "cpu")
    out = lambda mode: check.reference_outputs(fp32.config, fp32.traffic, fp32.steps, w, rec,
                                               "cpu", mode=mode, decode=False)["steps"]
    ref, unit = out("fp32"), out("unit")
    for name in check.NUMBERS[:2]:
        want = ref[name][2]
        assert float((unit[name][2] - want).norm()) > 1e-4 * float(want.norm())
