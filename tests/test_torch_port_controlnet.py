"""The ControlNet slice against the JAX package, on the toy bundles.

Both packages get one set of weights: the JAX toy bundle's ControlNet with
every leaf moved by 0.1 N(0, 1) (Flax's zero convolutions would make every
residual 0 and every check here vacuous), carried into the port through
``controlnet_from_jax`` (``tests/torch_port_common.py``). Inputs are numpy
arrays from a seed. fp32 on the CPU.

Bars: 3e-5 for the residuals and the UNet fed with them (those of
``tests/test_torch_port_perturbed.py``); per-step latent MAE < 1e-3 and
max < 1e-2 for ``generate_image`` (those of ``tests/test_parity.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elasticdiffusion_tpu_torch.configs import ViewConfig
from elasticdiffusion_tpu_torch.core.pipeline import ElasticDiffusion as TElastic
from elasticdiffusion_tpu_torch.core.background import PadSpec
from elasticdiffusion_tpu_torch.core.signals import (direction_condition,
                                                     image_conditions,
                                                     view_conditions)
from elasticdiffusion_tpu_torch.models.registry import load_bundle
from elasticdiffusion_tpu_torch.ops.views import build_view_plan
from toy_configs import toy_bundle_config
from torch_port_common import (TORCH_TOY_RUNTIME, toy_bundles,
                               max_abs, pipeline_parity_run,
                               port_bundle_config, t2n)

TOL = 3e-5


def _inputs(jb, B, xl, rng):
    ucfg = jb.config.unet
    vsf = jb.vae_scale_factor
    x = rng.standard_normal((B, 4, 8, 8)).astype(np.float32)
    ctx = rng.standard_normal((B, 77, ucfg.cross_attention_dim)
                              ).astype(np.float32)
    cond = rng.uniform(0, 1, (B, 3, 8 * vsf, 8 * vsf)).astype(np.float32)
    extra = {}
    if xl:
        extra = {"added_text_embeds": rng.standard_normal(
                     (B, ucfg.pooled_projection_dim)).astype(np.float32),
                 "added_time_ids": np.tile(np.asarray(
                     [[64., 96., 0., 0., 64., 96.]], np.float32), (B, 1))}
    return x, ctx, cond, extra


@pytest.mark.parametrize("xl,t,scale", [(False, 981.0, 1.0), (True, 500.0, 0.7)])
def test_residuals_and_unet_with_residuals_match_jax(xl, t, scale):
    jb, tb = toy_bundles(xl, "canny")
    x, ctx, cond, extra = _inputs(jb, 3, xl, np.random.default_rng(0))
    jkw = {k: jnp.asarray(v) for k, v in extra.items()}
    tkw = {k: torch.from_numpy(v) for k, v in extra.items()}
    jdown, jmid = jb.apply_controlnet(
        jnp.asarray(x), jnp.float32(t), jnp.asarray(ctx), jnp.asarray(cond),
        conditioning_scale=scale, **jkw)
    tdown, tmid = tb.apply_controlnet(
        torch.from_numpy(x), t, torch.from_numpy(ctx), torch.from_numpy(cond),
        conditioning_scale=scale, **tkw)
    # one residual per skip of the down path: conv_in, every resnet, every
    # downsampler
    n = len(jb.config.unet.block_out_channels)
    lpb = jb.config.unet.layers_per_block
    assert len(tdown) == len(jdown) == 1 + n * lpb + n - 1
    for j, tr in zip(jdown, tdown):
        want = np.asarray(j).transpose(0, 3, 1, 2)   # JAX residuals are NHWC
        assert tr.shape == want.shape
        assert np.abs(want).max() > 0.1              # the ControlNet is seen
        assert max_abs(t2n(tr), want) < TOL, max_abs(t2n(tr), want)
    want_mid = np.asarray(jmid).transpose(0, 3, 1, 2)
    assert np.abs(want_mid).max() > 0.1
    assert max_abs(t2n(tmid), want_mid) < TOL, max_abs(t2n(tmid), want_mid)

    # the UNet fed with each side's own residuals
    jeps = np.asarray(jb.apply_unet(
        jnp.asarray(x), jnp.float32(t), jnp.asarray(ctx),
        down_block_residuals=jdown, mid_block_residual=jmid, **jkw))
    teps = t2n(tb.apply_unet(
        torch.from_numpy(x), t, torch.from_numpy(ctx),
        down_block_residuals=tdown, mid_block_residual=tmid, **tkw))
    plain = t2n(tb.apply_unet(torch.from_numpy(x), t, torch.from_numpy(ctx),
                              **tkw))
    assert max_abs(teps, jeps) < TOL, max_abs(teps, jeps)
    assert max_abs(teps, plain) > 1e-2  # the residuals reach the output
    with pytest.raises(ValueError, match="down residuals"):
        tb.apply_unet(torch.from_numpy(x), t, torch.from_numpy(ctx),
                      down_block_residuals=tdown[:-1], **tkw)


def test_view_conditions_follow_the_view_crops():
    """Each view's condition is the first condition image, nearest-upsampled
    to the full latent's pixels, cropped at the view's rows and columns
    scaled by the VAE factor: pixel (y, x) of a view comes from latent
    position (rows[v, y // f], cols[v, x // f]), sub-pixel (y % f, x % f)."""
    plan = build_view_plan(16, 24, ViewConfig.from_sample_size(8))
    f, B = 2, 3
    rng = np.random.default_rng(3)
    cond = torch.from_numpy(rng.uniform(0, 1, (B, 3, 10, 14)).astype(np.float32))
    got = view_conditions(cond, plan, B, f)
    V, (oh, ow) = plan.num_views, plan.out_shape
    assert got.shape == (V * B, 3, oh * f, ow * f)
    up = torch.nn.functional.interpolate(cond[:1], size=(16 * f, 24 * f),
                                         mode="nearest")[0]
    for v in (0, V // 2, V - 1):
        for b in range(B):  # every image of the batch gets image 0's
            view = got[v * B + b]
            for y, x in ((0, 0), (oh * f - 1, ow * f - 1), (3, 5)):
                r = plan.rows[v, y // f] * f + y % f
                c = plan.cols[v, x // f] * f + x % f
                assert torch.equal(view[:, y, x], up[:, r, c])


def _per_call_views(cond, plan, B, f):
    """The local signal's conditions as each call built them before they
    were built once an image: pixel indices made in NumPy, then copied."""
    up = torch.nn.functional.interpolate(
        cond[:1], size=(plan.latent_h * f, plan.latent_w * f), mode="nearest")
    up = up.expand(B, *up.shape[1:])
    sub = np.arange(f)
    rows = torch.from_numpy((np.repeat(plan.rows * f, f, axis=1)
                             + np.tile(sub, plan.rows.shape[1])).astype(np.int64))
    cols = torch.from_numpy((np.repeat(plan.cols * f, f, axis=1)
                             + np.tile(sub, plan.cols.shape[1])).astype(np.int64))
    views = up[:, :, rows[:, :, None], cols[:, None, :]].permute(2, 0, 1, 3, 4)
    return views.reshape(-1, *views.shape[2:])


@pytest.mark.parametrize("B,dtype", [(1, torch.float32), (2, torch.float32),
                                     (1, torch.bfloat16)])
def test_conditions_built_once_equal_the_per_call_build(B, dtype):
    """``image_conditions`` against what each estimator call built before:
    the direction's zero-padded condition tiled over 2 (rs + 1) blocks
    (rs = 3) and the repaint's pair (rs = 0), the views whole and in
    ragged chunks of 5, each cast to the ControlNet's dtype as its forward
    casts it. One image is broadcast without a copy."""
    plan = build_view_plan(16, 24, ViewConfig.from_sample_size(8))
    f, pad = 2, PadSpec(5, 7, 8, 8)
    rng = np.random.default_rng(4)
    cond = torch.from_numpy(rng.uniform(0, 1, (B, 3, 10, 14)).astype(np.float32))
    got = image_conditions(cond, pad, plan, B, f, dtype)
    l, r, t, b = pad.pads
    low = torch.nn.functional.pad(cond, (l * f, r * f, t * f, b * f))
    for n_sub in (4, 1):
        d = direction_condition(got.padded, 2 * n_sub)
        assert d.dtype == dtype
        assert torch.equal(d, low.repeat(2 * n_sub, 1, 1, 1).to(dtype))
        assert (d.stride(0) == 0) == (B == 1)
    want = _per_call_views(cond, plan, B, f)
    V = plan.num_views
    for chunk in (V * B, 5 * B):
        for lo in range(0, V * B, chunk):
            rows = slice(lo, min(lo + chunk, V * B))
            assert torch.equal(got.views[rows], want[rows].to(dtype))


def test_generate_image_with_condition_matches_jax(monkeypatch, tmp_path):
    """Two prompts with two different conditions, at a size with many
    views (24), a padded low-resolution latent, repaint, rs = 1 and the
    port's view pass in ragged chunks of 5: the zero padding of the
    direction's condition, the local signal's first-image broadcast and its
    view crops, and the chunking all run."""
    jb, tb = toy_bundles(controlnet="canny")
    rng = np.random.default_rng(7)
    cond = rng.uniform(0, 1, (2, 3, 20, 24)).astype(np.float32)
    steps = 2
    jp, tp, jimg, jlats, timg, tinfo, tlats = pipeline_parity_run(
        jb, tb, monkeypatch, tmp_path, repaint=True, rrg=True, rs=1,
        steps=steps, prompts=("a photo of a cat", "a dog"), port_view_batch=5,
        condition_image=cond, controlnet_conditioning_scale=0.8)
    assert tp.last_metrics["views"] == 24
    assert len(jlats) == len(tlats) == steps
    for i, (a, b) in enumerate(zip(tlats, jlats)):
        d = np.abs(a - b)
        assert d.mean() < 1e-3 and d.max() < 1e-2, (i, d.mean(), d.max())
    assert timg.shape == jimg.shape == (2, 3, 32, 48)
    assert np.abs(timg - jimg).max() < 1e-2


def _port_run(tb, **kw):
    tp = TElastic(bundle=tb, device="cpu", controlnet_model="canny")
    tp.seed_everything(3)
    _, info = tp.generate_image("a cat", height=32, width=48,
                                num_inference_steps=2, resampling_steps=1,
                                return_arrays=True, **kw)
    return info["latent"]


def test_conditioning_scale_zero_is_the_run_without_controlnet():
    _, tb = toy_bundles(controlnet="canny")
    cond = np.random.default_rng(5).uniform(0, 1, (1, 3, 16, 16)).astype(
        np.float32)
    plain = _port_run(tb)
    zero = _port_run(tb, condition_image=cond,
                     controlnet_conditioning_scale=0.0)
    full = _port_run(tb, condition_image=cond)
    np.testing.assert_array_equal(zero, plain)
    assert np.abs(full - plain).max() > 1e-3


def test_condition_needs_a_controlnet_and_its_shape():
    plain_bundle = load_bundle("toy", TORCH_TOY_RUNTIME, device="cpu",
                               bundle_config=port_bundle_config(
                                   toy_bundle_config()))
    _, tb = toy_bundles(controlnet="canny")
    kw = dict(height=32, width=48, num_inference_steps=1, resampling_steps=0)
    with pytest.raises(ValueError, match="ControlNet"):
        TElastic(bundle=plain_bundle, device="cpu").generate_image(
            "a cat", condition_image=np.zeros((1, 3, 8, 8), np.float32), **kw)
    with pytest.raises(ValueError, match="condition must be"):
        TElastic(bundle=tb, device="cpu").generate_image(
            "a cat", condition_image=np.zeros((2, 3, 8, 8), np.float32), **kw)
    with pytest.raises(ValueError, match="no ControlNet"):
        plain_bundle.apply_controlnet(torch.zeros(1, 4, 8, 8), 1.0,
                                      torch.zeros(1, 77, 16),
                                      torch.zeros(1, 3, 16, 16))
