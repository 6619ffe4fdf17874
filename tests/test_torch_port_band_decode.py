"""The band route of ``halo_decode`` launches what ``band_norm_shapes`` lists.

``chip_smoke.py`` builds the GroupNorm kernel cases of its decode phase's
band route (``halo_decode(num_bands=4)``) from
``parallel/halo_decode.py::band_norm_shapes``, and fails on the card when
the route launches a shape no case checked. Here the route runs on the CPU
on a narrow VAE whose widths (128, 256) keep every GroupNorm at 32 groups
of at least 4 channels (``models/layers.py::clamped_groups``), so
that every norm goes through the dispatch that launches the kernel on a CUDA
tensor; the dispatch is wrapped to record the launch key the kernel's
wrapper would record there (``kernels.note_launch``, the keys
``chip_smoke.py`` checks), in order, and the record is held to
``band_norm_shapes``. At the card's own sizes the listed shapes are checked
to be kernel cases of ``chip_smoke.groupnorm_cases()``.
"""

import collections
import types

import numpy as np
import pytest
import torch

import chip_smoke
import elasticdiffusion_tpu_torch.kernels as kernels
from elasticdiffusion_tpu_torch.configs import VAEConfig, get_bundle_config
from elasticdiffusion_tpu_torch.models import layers
from elasticdiffusion_tpu_torch.models.vae import AutoencoderKL
from elasticdiffusion_tpu_torch.parallel import halo_decode as thd

NARROW = VAEConfig(block_out_channels=(128, 256), layers_per_block=1)


class _InOrder(collections.Counter):
    """A launch log that also keeps the order of the launches."""

    def __init__(self):
        super().__init__()
        self.order = []

    def __setitem__(self, key, value):
        self.order.append(key)
        super().__setitem__(key, value)


def _bundle(dtype):
    torch.manual_seed(0)
    vae = AutoencoderKL(NARROW).to(dtype).eval()
    for name, p in vae.named_parameters():
        if "norm" in name:  # the compute copy keeps fp32 norm weights
            p.data = p.data.float()
    return types.SimpleNamespace(fp32_decode=False, vae=vae, vae_fp32=vae,
                                 vae_scale_factor=NARROW.scale_factor)


def _launches(monkeypatch, bundle, z, **kw):
    """The fused_group_norm launch keys of one halo_decode, in order."""
    group_norm = layers.group_norm

    def record(x, weight, bias, groups, eps, silu, use_kernels):
        kernels.note_launch("fused_group_norm", str(x.dtype), str(weight.dtype),
                            float(eps), *x.shape, bool(silu))
        return group_norm(x, weight, bias, groups, eps, silu,
                          use_kernels=use_kernels)

    monkeypatch.setattr(layers, "group_norm", record)
    monkeypatch.setattr(kernels, "launch_log", _InOrder())
    with torch.no_grad():
        img = thd.halo_decode(bundle, z, **kw)
    return img, kernels.launch_log.order


def _keys(dtype, shapes):
    return [("fused_group_norm", str(dtype), str(torch.float32), 1e-6, *shape,
             silu) for shape, silu in shapes]


# (latent rows, columns, num_bands, halo): bands of 4 rows widened by 2 a
# side; a halo that widens every band to the whole latent; 4 bands that do
# not divide 18 rows (3 bands of 6, widened by 1); one band (monolithic)
BANDS = [(16, 6, 4, 2), (16, 6, 4, 16), (18, 5, 4, 1), (8, 8, 1, 16)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("h,w,n,halo", BANDS,
                         ids=["bands", "whole_windows", "uneven", "one_band"])
def test_band_norm_shapes_are_the_launches(monkeypatch, dtype, h, w, n, halo):
    bundle = _bundle(dtype)
    z = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (1, 4, h, w)).astype(np.float32))
    img, seen = _launches(monkeypatch, bundle, z, num_bands=n, halo=halo)
    assert img.shape == (1, 3, 2 * h, 2 * w)
    assert torch.isfinite(img.float()).all()
    assert seen == _keys(dtype, thd.band_norm_shapes(NARROW, 1, h, w, n, halo))


def test_stage_a_runs_once_and_every_band_runs_stage_b(monkeypatch):
    """5 norms at the latent (the mid block), then 3 bands x 9 of stage b
    (two resnets of two norms at each of two levels, and norm_out)."""
    shapes = thd.band_norm_shapes(NARROW, 1, 18, 5, 4, 1)
    assert len(shapes) == 5 + 3 * 9
    assert shapes[:5] == [((1, 18, 5, 256), s) for s in (True, True, False,
                                                         True, True)]
    assert shapes[5] == ((1, 8, 5, 256), True)
    assert shapes[-1] == ((1, 16, 10, 128), True)


@pytest.mark.parametrize("version,latent", [
    (p["sd_version"], p["decode"]) for p in chip_smoke.PATHS if "decode" in p])
def test_the_card_s_band_shapes_are_kernel_cases(version, latent):
    """Every GroupNorm of the decode phase's band route is a kernel case of
    the kernels phase, with the decoder's dtype, fp32 weights and eps."""
    cfg = get_bundle_config(version).vae
    dtype = torch.float32 if cfg.force_upcast else torch.bfloat16
    cases = {(c[1], c[2], c[3], *c[4:9]) for c in chip_smoke.groupnorm_cases()}
    shapes = thd.band_norm_shapes(cfg, 1, *latent, chip_smoke.DECODE_BANDS)
    assert len(shapes) == 5 + chip_smoke.DECODE_BANDS * (4 * 3 * 2 + 1)
    for shape, silu in shapes:
        assert (dtype, torch.float32, 1e-6, *shape, silu) in cases, shape
