"""SDXL in the port against the JAX package on the toy XL bundle: two text
encoders (the second tokenizer pads with id 0), text_time conditioning in
the UNet, the estimators with pooled embeddings and time ids, and
generate_image step by step, with the UNet's 3x3 convolutions on
``nn.Conv2d`` and on the conv kernel's plain version. fp32 on the CPU.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elasticdiffusion_tpu.core import signals as jsig
from elasticdiffusion_tpu.core.background import PadSpec as JPadSpec
from elasticdiffusion_tpu.core.pipeline import ElasticDiffusion as JElastic
from elasticdiffusion_tpu.ops.resample import build_resample_plan as j_resample_plan
from elasticdiffusion_tpu.ops.views import build_view_plan as j_view_plan

from elasticdiffusion_tpu_torch import configs as tcfg
from elasticdiffusion_tpu_torch.core import signals as tsig
from elasticdiffusion_tpu_torch.core.background import PadSpec as TPadSpec
from elasticdiffusion_tpu_torch.core.pipeline import ElasticDiffusion as TElastic
from elasticdiffusion_tpu_torch.ops.resample import build_resample_plan as t_resample_plan
from elasticdiffusion_tpu_torch.ops.views import build_view_plan as t_view_plan
from torch_port_common import max_abs, pipeline_parity_run, t2n, toy_bundles

TOL = 5e-5


def _xl():
    return toy_bundles(xl=True)


def test_toy_xl_bundle_is_built_like_the_jax_bundle():
    jb, tb = _xl()
    assert tb.config.is_xl and len(tb.text_models) == len(tb.tokenizers) == 2
    assert tb.tokenizers[0].pad_token_id == tb.tokenizers[0].eos_token_id
    assert tb.tokenizers[1].pad_token_id == jb.tokenizers[1].pad_token_id == 0
    assert hasattr(tb.text_models[1], "text_projection")
    assert tb.text_models[1].text_projection.bias is None
    assert hasattr(tb.unet, "add_embedding")


@pytest.mark.parametrize("prompt", ["a photo of a cat", "", "two words, and: punctuation!"])
def test_xl_tokenizers_and_encoders_match_jax(prompt):
    """Both encoders, and the pooled output of the second when the row is
    padded with id 0: the EOS feature is still the first highest id."""
    jb, tb = _xl()
    for enc in (0, 1):
        jids, tids = jb.tokenizers[enc]([prompt]), tb.tokenizers[enc]([prompt])
        np.testing.assert_array_equal(jids, tids)
        want = jb.encode_text(jids, enc)
        got = tb.encode_text(tids, enc)
        for g, w in zip(got, want):
            assert max_abs(t2n(g), np.asarray(w)) < TOL
    assert tids[0, -1] == 0 and int(np.argmax(tids[0])) == list(tids[0]).index(
        tb.tokenizers[1].eos_token_id)


@pytest.mark.parametrize("prompts", [["a photo of a cat"], ["", "a dog, a log"]])
def test_xl_get_text_embeds_matches_jax(prompts):
    jb, tb = _xl()
    jtext, jpooled = JElastic(bundle=jb).get_text_embeds(prompts)
    ttext, tpooled = TElastic(bundle=tb, device="cpu").get_text_embeds(prompts)
    assert ttext.shape == (len(prompts), 77, 16 + 24)
    assert tpooled.shape == (len(prompts), 24)
    assert ttext.dtype == tpooled.dtype == torch.float32
    assert max_abs(t2n(ttext), np.asarray(jtext)) < TOL
    assert max_abs(t2n(tpooled), np.asarray(jpooled)) < TOL


def _unet_inputs(B, hw=(8, 8), seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, 4) + hw).astype(np.float32),
            rng.standard_normal((B, 77, 40)).astype(np.float32),
            rng.standard_normal((B, 24)).astype(np.float32),
            np.tile(np.asarray([[128., 192., 0., 0., 128., 192.]], np.float32),
                    (B, 1)))


@pytest.mark.parametrize("t,hw,conv_impl", [(1.0, (8, 8), "cudnn"),
                                           (500.0, (8, 12), "cudnn"),
                                           (981.0, (8, 8), "kernel")])
def test_toy_xl_unet_matches_jax(t, hw, conv_impl):
    jb, tb = _xl()
    x, ctx, pooled, tids = _unet_inputs(3, hw)
    want = jb.apply_unet(jnp.asarray(x), jnp.float32(t), jnp.asarray(ctx),
                         added_text_embeds=jnp.asarray(pooled),
                         added_time_ids=jnp.asarray(tids))
    tb.set_conv_impl(conv_impl)
    try:
        got = tb.apply_unet(torch.from_numpy(x), t, torch.from_numpy(ctx),
                            added_text_embeds=torch.from_numpy(pooled),
                            added_time_ids=torch.from_numpy(tids))
    finally:
        tb.set_conv_impl("cudnn")
    assert got.shape == x.shape
    assert max_abs(t2n(got), np.asarray(want)) < TOL


def test_xl_unet_requires_the_added_conditioning():
    _, tb = _xl()
    x, ctx, pooled, tids = _unet_inputs(1)
    with pytest.raises(ValueError, match="added_text_embeds"):
        tb.apply_unet(torch.from_numpy(x), 1.0, torch.from_numpy(ctx))
    with pytest.raises(ValueError, match="add-embed dim"):
        tb.apply_unet(torch.from_numpy(x), 1.0, torch.from_numpy(ctx),
                      added_text_embeds=torch.from_numpy(pooled[:, :20]),
                      added_time_ids=torch.from_numpy(tids))


def test_xl_direction_with_resampling_matches_jax():
    """The pooled embeddings under resampling: [uncond x n_sub | cond x
    n_sub], each block repeating the prompts in order. B=2 with distinct
    pooled rows, so a wrong batch order shows."""
    jb, tb = _xl()
    B, H, W, rs = 2, 12, 12, 2
    rng = np.random.default_rng(5)
    lat = rng.standard_normal((B, 4, H, W)).astype(np.float32)
    text = rng.standard_normal((2 * B, 77, 40)).astype(np.float32)
    pooled = rng.standard_normal((2 * B, 24)).astype(np.float32)
    tids = np.asarray([[128., 128., 0., 0., 128., 128.]], np.float32)
    jplan, tplan = j_resample_plan(H, W, 8, 8), t_resample_plan(H, W, 8, 8)
    picks = rng.integers(0, 4, (rs + 1, jplan.num_blocks)).astype(np.int32)
    picks[0] = 0
    want = jsig.approximate_latent_direction(
        jb, jnp.asarray(lat), None, jnp.float32(500.0), jnp.asarray(text),
        jplan, JPadSpec(8, 8, 8, 8), {}, rs, 0.7,
        add_text_embeds_cfg=jnp.asarray(pooled), add_time_ids=jnp.asarray(tids),
        scripted_picks=jnp.asarray(picks))
    got = tsig.approximate_latent_direction(
        tb, torch.from_numpy(lat), None, 500.0, torch.from_numpy(text),
        tplan, TPadSpec(8, 8, 8, 8), {}, rs, 0.7,
        add_text_embeds_cfg=torch.from_numpy(pooled),
        add_time_ids=torch.from_numpy(tids), scripted_picks=picks)
    for name in got._fields:
        assert max_abs(t2n(getattr(got, name)), np.asarray(getattr(want, name))) < 1e-4, name


@pytest.mark.parametrize("view_batch_size", [0, 3])
def test_xl_local_signal_matches_jax(view_batch_size):
    jb, tb = _xl()
    B, H, W = 2, 12, 12
    rng = np.random.default_rng(6)
    lat = rng.standard_normal((B, 4, H, W)).astype(np.float32)
    text = rng.standard_normal((B, 77, 40)).astype(np.float32)
    pooled = rng.standard_normal((B, 24)).astype(np.float32)
    tids = np.asarray([[128., 128., 0., 0., 128., 128.]], np.float32)
    vc = tcfg.ViewConfig.from_sample_size(8)
    jplan = j_view_plan(H, W, JElastic(bundle=jb).view_config)
    tplan = t_view_plan(H, W, vc)
    want = jsig.compute_local_uncond_signal(
        jb, jnp.asarray(lat), jnp.float32(300.0), jnp.asarray(text), jplan,
        JPadSpec(*jplan.out_shape, 8, 8), {}, uncond_pooled=jnp.asarray(pooled),
        add_time_ids=jnp.asarray(tids))
    got = tsig.compute_local_uncond_signal(
        tb, torch.from_numpy(lat), 300.0, torch.from_numpy(text), tplan,
        TPadSpec(*tplan.out_shape, 8, 8), {}, uncond_pooled=torch.from_numpy(pooled),
        add_time_ids=torch.from_numpy(tids), view_batch_size=view_batch_size)
    assert max_abs(t2n(got), np.asarray(want)) < 1e-4


def test_xl_add_time_ids_carry_the_4x_quirk():
    _, tb = _xl()
    tp = TElastic(bundle=tb, device="cpu")
    ids = tp._get_add_time_ids((4 * 32, 4 * 48), (0, 0), (4 * 32, 4 * 48))
    assert ids.dtype == torch.float32
    assert ids.tolist() == [[128.0, 192.0, 0.0, 0.0, 128.0, 192.0]]


@pytest.mark.parametrize("repaint,rrg,rs,conv_impl", [
    (False, True, 1, "cudnn"),
    (True, True, 2, "cudnn"),
    (True, True, 2, "kernel"),
])
def test_xl_generate_image_matches_jax_pipeline(repaint, rrg, rs, conv_impl,
                                                monkeypatch, tmp_path):
    jb, tb = _xl()
    steps, height, width = 2, 32, 48
    tb.set_conv_impl(conv_impl)
    try:
        jp, tp, jimg, jlats, timg, tinfo, tlats = pipeline_parity_run(
            jb, tb, monkeypatch, tmp_path, repaint=repaint, rrg=rrg, rs=rs,
            steps=steps, height=height, width=width)
    finally:
        tb.set_conv_impl("cudnn")
    assert len(jlats) == len(tlats) == steps
    for i, (a, b) in enumerate(zip(tlats, jlats)):
        d = np.abs(a - b)
        assert d.mean() < 1e-3 and d.max() < 1e-2, (i, d.mean(), d.max())
    assert timg.shape == jimg.shape == (1, 3, height, width)
    assert np.abs(timg - jimg).max() < 1e-2
    assert tp.last_metrics["unet_view_forwards"] == \
        jp.last_metrics["unet_view_forwards"]


def test_xl_vanilla_generate_and_verbose_log():
    """generate() with pooled embeddings and time ids against JAX, and the
    verbose image log, which reruns the low-resolution latent through it."""
    jb, tb = _xl()
    jp, tp = JElastic(bundle=jb), TElastic(bundle=tb, device="cpu", verbose=True,
                                           log_freq=1)
    rng = np.random.default_rng(1)
    lat = rng.standard_normal((1, 4, 8, 8)).astype(np.float32)
    ju, jpu = jp.get_text_embeds([""])
    jc, jpc = jp.get_text_embeds(["a photo of a cat"])
    text = np.concatenate([np.asarray(ju), np.asarray(jc)])
    pooled = np.concatenate([np.asarray(jpu), np.asarray(jpc)])
    tids = np.asarray([[128., 128., 0., 0., 128., 128.]], np.float32)
    jimg, _ = jp.generate(jnp.asarray(lat), jnp.asarray(text), jnp.asarray(pooled),
                          num_inference_steps=3, add_time_ids=jnp.asarray(tids))
    timg, _ = tp.generate(lat, torch.from_numpy(text), torch.from_numpy(pooled),
                          num_inference_steps=3, add_time_ids=torch.from_numpy(tids))
    assert np.abs(t2n(timg) - np.asarray(jimg)).max() < 1e-3
    _, log = tp.generate_image("a cat", height=32, width=48,
                               num_inference_steps=2, resampling_steps=1)
    assert {"global_img", "intermediate_x0_imgs"} <= set(log)


def test_xl_force_upcast_decode_runs_in_fp32():
    """force_upcast: the decode takes the fp32 VAE whatever the compute
    dtype; without it the compute-dtype copy."""
    import dataclasses
    from elasticdiffusion_tpu_torch.models.registry import load_bundle
    _, tb = _xl()
    cfg = dataclasses.replace(
        tb.config, vae=dataclasses.replace(tb.config.vae, force_upcast=True))
    rt = tcfg.RuntimeConfig(param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16)
    b = load_bundle("toy-xl", rt, bundle_config=cfg, device="cpu")
    z = torch.zeros(1, 4, 4, 4, dtype=torch.bfloat16)
    assert b.vae_decode(z).dtype == torch.float32
    rt = dataclasses.replace(rt, vae_decode_fp32=False)
    b = load_bundle("toy-xl", rt, bundle_config=cfg, device="cpu")
    assert b.vae_decode(z).dtype == torch.bfloat16
    assert tcfg.get_bundle_config("XL1.0").vae.force_upcast
