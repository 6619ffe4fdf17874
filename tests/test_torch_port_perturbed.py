"""Model-level parity with every parameter perturbed.

The toy bundles carry the Flax init into the port, and that init makes every
Dense/Conv bias 0 and every norm scale/bias 1/0: a bias or norm affine wired
to the wrong place in a whole model cannot show there. Here every leaf of the
toy JAX parameters moves by 0.1 N(0, 1) from a numpy seed (as
tests/test_torch_port_layers.py does block by block), the perturbed trees are
carried into the port through models/convert.py, and the toy UNet (SD and
SDXL), the VAE encode and decode, CLIP (both SDXL encoders) and one short
generate_image run are held to the JAX package again.

Bars: 3e-5 for the models, those of tests/test_torch_port_layers.py;
per-step latent MAE < 1e-3 (max < 1e-2) for the pipeline, those of
tests/test_parity.py. fp32 on the CPU.
"""

import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elasticdiffusion_tpu_torch.models.convert import (
    clip_from_jax, unet_from_jax, vae_from_jax)
from elasticdiffusion_tpu_torch.models.registry import load_bundle
from torch_port_common import (TORCH_TOY_RUNTIME, max_abs, perturb_tree,
                               pipeline_parity_run, port_bundle_config, t2n,
                               toy_bundles)

TOL = 3e-5


@functools.lru_cache(maxsize=2)
def _perturbed_params(xl: bool):
    """Perturbed copies of the cached toy bundle's JAX trees, and the port's
    toy bundle loaded with the same trees."""
    jb, _ = toy_bundles(xl)
    rng = np.random.default_rng(11 if xl else 10)
    unet = perturb_tree(jb.unet_params, rng)
    vae = perturb_tree(jb.vae_params, rng)
    text = tuple(perturb_tree(p, rng) for p in jb.text_params)
    tp = load_bundle(jb.config.sd_version, TORCH_TOY_RUNTIME,
                     bundle_config=port_bundle_config(jb.config), device="cpu")
    tp.unet.load_state_dict(unet_from_jax(unet))
    tp.vae_fp32.load_state_dict(vae_from_jax(vae))
    for model, params in zip(tp.text_models, text):
        model.load_state_dict(clip_from_jax(params))
    jparams = {"unet_params": jax.tree.map(jnp.asarray, unet),
               "vae_params": jax.tree.map(jnp.asarray, vae),
               "text_params": tuple(jax.tree.map(jnp.asarray, t) for t in text)}
    return jparams, tp


@contextlib.contextmanager
def perturbed_bundles(xl: bool = False):
    """(JAX bundle, port bundle) with every parameter moved off its init.
    The cached JAX toy bundle is reused with its parameter trees swapped for
    the perturbed ones while the block runs: its jitted forwards take the
    parameters as arguments, so nothing is traced or compiled again."""
    jb, _ = toy_bundles(xl)
    jparams, tp = _perturbed_params(xl)
    saved = {k: getattr(jb, k) for k in jparams}
    for k, v in jparams.items():
        setattr(jb, k, v)
    try:
        yield jb, tp
    finally:
        for k, v in saved.items():
            setattr(jb, k, v)


def test_every_parameter_moved_off_its_init():
    """The perturbation reaches the port: no bias is 0 and no norm weight 1."""
    _, tp = _perturbed_params(False)
    for name, p in tp.unet.named_parameters():
        if name.endswith("bias") or ("norm" in name and name.endswith("weight")):
            assert not torch.all(p == (1.0 if name.endswith("weight") else 0.0)), name


@pytest.mark.parametrize("xl,t", [(False, 1.0), (False, 981.0), (True, 500.0)])
def test_perturbed_unet_matches_jax(xl, t):
    with perturbed_bundles(xl) as (jb, tb):
        rng = np.random.default_rng(0)
        # the shapes of tests/test_torch_port_models.py and _sdxl.py, whose
        # compiled JAX forwards a process may already hold
        x = rng.standard_normal((3, 4, 8, 8)).astype(np.float32)
        ctx = rng.standard_normal((3, 77, jb.config.unet.cross_attention_dim)
                                  ).astype(np.float32)
        jkw, tkw = {}, {}
        if xl:
            pooled = rng.standard_normal((3, 24)).astype(np.float32)
            tids = np.tile(np.asarray([[64., 96., 0., 0., 64., 96.]], np.float32),
                           (3, 1))
            jkw = dict(added_text_embeds=jnp.asarray(pooled),
                       added_time_ids=jnp.asarray(tids))
            tkw = dict(added_text_embeds=torch.from_numpy(pooled),
                       added_time_ids=torch.from_numpy(tids))
        want = np.asarray(jb.apply_unet(jnp.asarray(x), jnp.float32(t),
                                        jnp.asarray(ctx), **jkw))
        got = t2n(tb.apply_unet(torch.from_numpy(x), t, torch.from_numpy(ctx), **tkw))
        assert got.shape == x.shape
        assert max_abs(got, want) < TOL, max_abs(got, want)


@pytest.mark.parametrize("which", ["decode", "encode"])
def test_perturbed_vae_matches_jax(which):
    with perturbed_bundles() as (jb, tb):
        rng = np.random.default_rng(1)
        if which == "decode":
            z = rng.standard_normal((1, 4, 6, 8)).astype(np.float32)
            want = np.asarray(jb.vae_decode(jnp.asarray(z)))
            got = t2n(tb.vae_decode(torch.from_numpy(z)))
        else:
            img = rng.uniform(-1, 1, (1, 3, 12, 16)).astype(np.float32)
            nz = rng.standard_normal((1, 4, 6, 8)).astype(np.float32)
            want = np.asarray(jb.vae_encode_sample(jnp.asarray(img), jnp.asarray(nz)))
            got = t2n(tb.vae_encode_sample(torch.from_numpy(img), torch.from_numpy(nz)))
        assert got.shape == want.shape
        assert max_abs(got, want) < TOL, max_abs(got, want)


@pytest.mark.parametrize("xl,encoder", [(False, 0), (True, 0), (True, 1)])
def test_perturbed_clip_matches_jax(xl, encoder):
    with perturbed_bundles(xl) as (jb, tb):
        prompt = ["a photo of a lighthouse, at dusk"]
        jids, tids = jb.tokenizers[encoder](prompt), tb.tokenizers[encoder](prompt)
        np.testing.assert_array_equal(jids, tids)
        want = jb.encode_text(jids, encoder)
        got = tb.encode_text(tids, encoder)
        for g, w in zip(got, want):
            assert max_abs(t2n(g), np.asarray(w)) < TOL, max_abs(t2n(g), np.asarray(w))


def test_perturbed_generate_image_matches_jax(monkeypatch, tmp_path):
    with perturbed_bundles() as (jb, tb):
        steps = 2
        _, _, jimg, jlats, timg, tinfo, tlats = pipeline_parity_run(
            jb, tb, monkeypatch, tmp_path, repaint=True, rrg=False, rs=1,
            steps=steps)
        assert len(jlats) == len(tlats) == steps
        for i, (a, b) in enumerate(zip(tlats, jlats)):
            d = np.abs(a - b)
            assert d.mean() < 1e-3 and d.max() < 1e-2, (i, d.mean(), d.max())
        assert np.abs(timg - jimg).max() < 1e-2
