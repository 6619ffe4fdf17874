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
    ref16 = check.reference_outputs(cell.config, cell.traffic, cell.steps,
                                    wts.make_weights(cell.config, 5, "cpu"), rec,
                                    "cpu", mode="bf16", decode=False)
    got = check.program_readings(rec, ref, ref16)
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
