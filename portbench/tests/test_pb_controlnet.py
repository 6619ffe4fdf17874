"""The ControlNet in the harness: the plain reference's ``ControlNet``
against the port's at float32 on the CPU, its names against the port's at
SDXL's published widths, the toy ControlNet cell driven through a run to
``correct``, and a run whose ControlNet is cut off underneath read as not
correct."""

import pytest
import torch

import toy
from portbench import program
from portbench import weights as wts
from portbench.cells import load_cell
from portbench.reference import models as M
from portbench.run import run_cell


def _port_controlnet(cfg, weights):
    from elasticdiffusion_tpu_torch.configs import ControlNetConfig
    from elasticdiffusion_tpu_torch.models.controlnet import ControlNet
    from elasticdiffusion_tpu_torch.models.convert import hf_to_port, load_into
    vsf = 2 ** (len(cfg["vae"]["block_out_channels"]) - 1)
    net = ControlNet(ControlNetConfig(unet=program.bundle_config(cfg).unet,
                                      cond_downsample_factor=vsf)).float().eval()
    load_into(net, hf_to_port(weights["controlnet"], "controlnet"), "controlnet")
    return net


@torch.no_grad()
def test_reference_controlnet_and_unet_follow_the_port_in_fp32():
    """The residuals of both ControlNets, and the UNet that takes them, on
    the same seeded weights and inputs, agree to float32 rounding."""
    from elasticdiffusion_tpu_torch.models.convert import hf_to_port, load_into
    from elasticdiffusion_tpu_torch.models.unet import UNet2DCondition
    cfg = toy.canny_config()
    weights = wts.make_weights(cfg, 21, "cpu")
    fp32 = M.Precision("fp32")
    ref_cn = M.materialise(M.build("controlnet", cfg["controlnet"]),
                           weights["controlnet"], "cpu", fp32)
    ref_unet = M.materialise(M.build("unet", cfg["unet"]), weights["unet"], "cpu", fp32)
    port_cn = _port_controlnet(cfg, weights)
    port_unet = UNet2DCondition(program.bundle_config(cfg).unet).float().eval()
    load_into(port_unet, hf_to_port(weights["unet"], "unet"), "unet")

    g = torch.Generator().manual_seed(3)
    B, u = 3, cfg["unet"]
    x = torch.randn(B, 4, 16, 16, generator=g)
    ctx = torch.randn(B, 77, u["cross_attention_dim"], generator=g)
    text = torch.randn(B, 32, generator=g)
    tid = torch.tensor([[128.0, 256.0, 0.0, 0.0, 128.0, 256.0]]).expand(B, 6)
    cond = (torch.rand(B, 3, 32, 32, generator=g) > 0.9).float()
    down, mid = ref_cn(x, 501.0, ctx, cond, 0.5, fp32, text, tid)
    pdown, pmid = port_cn(x, torch.full((B,), 501.0), ctx, cond, 0.5, text, tid)
    assert len(down) == len(pdown) == 1 + 2 * len(u["block_out_channels"]) - 1
    rel = lambda a, b: float((a - b.float()).norm() / a.norm())
    for a, b in zip(down + [mid], list(pdown) + [pmid]):
        assert a.norm() > 0 and rel(a, b) < 1e-5
    want = ref_unet(x, 501.0, ctx, fp32, text, tid, down, mid)
    got = port_unet(x, torch.full((B,), 501.0), ctx, text, tid, pdown, pmid)
    assert rel(want, got) < 1e-5
    assert rel(want, ref_unet(x, 501.0, ctx, fp32, text, tid)) > 1e-2


def test_controlnet_names_are_the_ports_at_sdxls_widths():
    """Every name and shape of the benchmark's ControlNet at the published
    canny SDXL widths is a parameter of the port's ControlNet, and none is
    missing; the harness takes the block."""
    from elasticdiffusion_tpu_torch.configs import ControlNetConfig
    from elasticdiffusion_tpu_torch.models.controlnet import ControlNet
    from elasticdiffusion_tpu_torch.models.convert import hf_to_port
    cfg = load_cell("sdxl-1024x2048").config
    cfg["controlnet"] = {**cfg["unet"], **toy.CANNY_SDXL}
    program.check_controlnet(cfg)
    with torch.device("meta"):
        theirs = ControlNet(ControlNetConfig(unet=program.bundle_config(cfg).unet,
                                             cond_downsample_factor=8)).state_dict()
        mine = hf_to_port(M.build("controlnet", cfg["controlnet"]).state_dict(), "controlnet")
    assert set(mine) == set(theirs)
    assert all(tuple(mine[k].shape) == tuple(theirs[k].shape) for k in mine)
    n = sum(t.numel() for t in mine.values())
    assert 1.2e9 < n < 1.3e9, n


@pytest.mark.parametrize("key,value", [("transformer_layers_per_block", [0, 2, 2]),
                                       ("conditioning_embedding_out_channels", [32, 256]),
                                       ("kind", "seg"),
                                       ("global_pool_conditions", True)])
def test_a_controlnet_the_port_does_not_build_is_refused(key, value):
    cfg = toy.canny_config()
    cfg["controlnet"][key] = value
    with pytest.raises(ValueError):
        program.check_controlnet(cfg)


def _run(seed=77):
    return run_cell(toy.cell("canny"), seed, 0.01, False, device="cpu", t0=0.0,
                    metric_names=["image_s"])


def test_the_toy_controlnet_cell_runs_to_correct():
    r = _run()
    assert r["correct"], r["checks"]


def _residuals_dropped(monkeypatch):
    from elasticdiffusion_tpu_torch.models.registry import ModelBundle
    orig = ModelBundle.apply_unet

    def drop(self, x, t, ctx, down_block_residuals=None, mid_block_residual=None, **kw):
        return orig(self, x, t, ctx, **kw)
    monkeypatch.setattr(ModelBundle, "apply_unet", drop)


def _scale_zero(monkeypatch):
    from elasticdiffusion_tpu_torch.models.registry import ModelBundle
    orig = ModelBundle.apply_controlnet
    monkeypatch.setattr(ModelBundle, "apply_controlnet",
                        lambda self, *a, conditioning_scale=1.0, **kw:
                        orig(self, *a, conditioning_scale=0.0, **kw))


@pytest.mark.parametrize("fault", [_residuals_dropped, _scale_zero])
def test_a_controlnet_cut_off_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    r = _run()
    assert not r["correct"], r["checks"]
