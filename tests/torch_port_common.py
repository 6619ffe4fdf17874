"""Shared helpers of the port's CPU tests (tests/test_torch_port_*.py).

Both packages are imported here and only here and in the tests: the port
itself never imports jax or the JAX package. Inputs are numpy arrays made
from a seed; weights are carried from the JAX toy bundle into the port's
modules through models/convert.py.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from toy_configs import make_toy_bundle

from elasticdiffusion_tpu_torch import configs as tcfg
from elasticdiffusion_tpu_torch.models.convert import (
    clip_from_jax, controlnet_from_jax, unet_from_jax, vae_from_jax)
from elasticdiffusion_tpu_torch.models.registry import load_bundle

TORCH_TOY_RUNTIME = tcfg.RuntimeConfig(param_dtype=torch.float32,
                                       compute_dtype=torch.float32)


def port_config(cfg, cls):
    """A JAX-package config dataclass as the port's dataclass of class cls."""
    return cls(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cls)})


def port_bundle_config(jc) -> tcfg.ModelBundleConfig:
    return tcfg.ModelBundleConfig(
        sd_version=jc.sd_version, model_key=jc.model_key,
        unet=port_config(jc.unet, tcfg.UNetConfig),
        vae=port_config(jc.vae, tcfg.VAEConfig),
        text_encoders=tuple(port_config(t, tcfg.CLIPTextConfig)
                            for t in jc.text_encoders),
        is_xl=jc.is_xl, native_resolution=jc.native_resolution,
        min_latent_size=jc.min_latent_size)


def to_numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


def perturb_tree(tree, rng):
    """Every leaf of a JAX parameter tree moved by 0.1 N(0, 1) (numpy)."""
    leaves, treedef = jax.tree.flatten(to_numpy_tree(tree))
    return jax.tree.unflatten(treedef, [
        l + 0.1 * rng.standard_normal(l.shape).astype(np.float32)
        for l in leaves])


@functools.lru_cache(maxsize=4)
def toy_bundles(xl: bool = False, controlnet=None):
    """(JAX toy SD bundle, the port's bundle on the CPU with its weights);
    xl=True gives the toy SDXL pair (two text encoders, text_time UNet).
    controlnet='canny' adds a ControlNet to both. Flax gives its zero
    convolutions and its conditioning embedding's conv_out zero weights,
    which would make every residual 0: every leaf of the JAX ControlNet
    moves by 0.1 N(0, 1) first."""
    jb = make_toy_bundle(xl=xl, controlnet=controlnet)
    tb = load_bundle(jb.config.sd_version, TORCH_TOY_RUNTIME,
                     bundle_config=port_bundle_config(jb.config),
                     controlnet_model=controlnet, device="cpu")
    tb.unet.load_state_dict(unet_from_jax(to_numpy_tree(jb.unet_params)))
    tb.vae_fp32.load_state_dict(vae_from_jax(to_numpy_tree(jb.vae_params)))
    for model, params in zip(tb.text_models, jb.text_params):
        model.load_state_dict(clip_from_jax(to_numpy_tree(params)))
    if controlnet is not None:
        cn = perturb_tree(jb.controlnet_params,
                          np.random.default_rng(21 if xl else 20))
        jb.controlnet_params = jax.tree.map(jnp.asarray, cn)
        tb.controlnet.load_state_dict(controlnet_from_jax(cn))
    return jb, tb


def t2n(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def max_abs(a, b) -> float:
    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max())


def _scripted(rng, steps, rs, N, shape, repaint):
    picks_main, picks_repaint, noise = [], [], []
    for _ in range(steps):
        p = rng.integers(0, 4, (rs + 1, N)).astype(np.int32)
        p[0] = 0  # the deterministic top-left pick of substep 0
        picks_main.append(p)
        picks_repaint.append(np.zeros((1, N), np.int32))
        noise.append(rng.standard_normal((1000 // steps,) + shape).astype(np.float32))
    scripted = {"picks_main": picks_main}
    if repaint:
        scripted.update(picks_repaint=picks_repaint, repaint_noise=noise)
    return scripted


def _jax_step_latents(pipe, tmp_path, prompts="a photo of a cat", **kw):
    """Per-step-end latents of the JAX pipeline: it checkpoints the latent
    after every step, and a progress wrapper reads each checkpoint back
    before the next step overwrites it."""
    path = str(tmp_path / "latent.npz")
    seen = []

    def progress(steps):
        for i in steps:
            if i > 0:
                seen.append(np.load(path)["latent"])
            yield i

    img, info = pipe.generate_image(prompts, progress=progress,
                                    checkpoint_path=path, checkpoint_every=1,
                                    return_arrays=True, **kw)
    return img, seen + [info["latent"]]


def pipeline_parity_run(jb, tb, monkeypatch, tmp_path, repaint, rrg, rs,
                        steps=2, height=32, width=48,
                        prompts=("a photo of a cat",), port_view_batch=0,
                        **extra):
    """Both pipelines on the same injected initial latent, picks and repaint
    noise (numpy, from a seed) and the same background tables: the JAX
    package draws them with jax.random inside make_background_table, so the
    JAX tables are recorded and handed to the port in the place of its own.
    One latent per prompt; `extra` goes to both generate_image calls (a
    ControlNet condition, its scale); `port_view_batch` chunks the port's
    view pass (the JAX package runs it in one call).
    Returns (jax pipe, port pipe, jax image, jax per-step latents, port
    image, port info, port per-step latents)."""
    import elasticdiffusion_tpu.core.pipeline as jpipe
    from elasticdiffusion_tpu.ops.resample import build_resample_plan
    from elasticdiffusion_tpu_torch.core import background as tbg
    from elasticdiffusion_tpu_torch.core.pipeline import ElasticDiffusion as TElastic

    jp = jpipe.ElasticDiffusion(bundle=jb)
    jp.seed_everything(0)
    tp = TElastic(bundle=tb, device="cpu", view_batch_size=port_view_batch)
    tp.seed_everything(0)
    vsf = jb.vae_scale_factor
    H, W = height // vsf, width // vsf
    plan = build_resample_plan(H, W, *jp.get_downsample_size(height, width))
    rng = np.random.default_rng(0)
    B = len(prompts)
    init = rng.standard_normal((B, 4, H, W)).astype(np.float32)
    kw = dict(height=height, width=width, num_inference_steps=steps,
              guidance_scale=7.5, resampling_steps=rs, new_p=0.3,
              rrg_init_weight=1000.0 if rrg else 0.0, rrg_stop_t=0.0,
              repaint_sampling=repaint, latents=init,
              scripted_noise=_scripted(rng, steps, rs, plan.num_blocks,
                                       (B, 4, H, W), repaint), **extra)

    recorded = []
    j_make = jpipe.make_background_table

    def record(*a, **k):
        recorded.append(j_make(*a, **k))
        return recorded[-1]

    monkeypatch.setattr(jpipe, "make_background_table", record)
    jimg, jlats = _jax_step_latents(jp, tmp_path, list(prompts), **kw)
    assert recorded, "the toy geometry must pad with backgrounds"

    replay = iter(recorded)
    monkeypatch.setattr(
        tbg, "make_background_table",
        lambda *a, **k: {s: torch.tensor(np.asarray(v))
                         for s, v in next(replay).items()})
    timg, tinfo = tp.generate_image(list(prompts), return_arrays=True, **kw)
    tlats = [t2n(l) for l in tp.last_step_latents]
    return jp, tp, jimg, jlats, timg, tinfo, tlats
