"""The SD 1.5 production request in both packages, at full width.

The JAX package's slow tier holds its pipeline at the reference's real
operating point (tests/test_parity_production.py): the full SD 1.5
architecture at 512x768 px, resampling_steps 7, repaint and RRG, guidance
10, new_p 0.3, two steps. Here the port's ``generate_image`` answers the
same request on the same weights and the same injected randomness as the
JAX package's: both bundles are SD 1.5 at full width in fp32, the JAX
parameters initialised from its seed with every leaf moved by 0.1 N(0, 1)
from a numpy seed and carried into the port by ``*_from_jax``; the initial
latent, the resampling picks and the repaint noise are numpy arrays from a
seed (``scripted_noise``), and the background tables the JAX package draws
are replayed into the port, as tests/torch_port_common.py
``pipeline_parity_run`` does at toy size. The JAX pipeline runs its
segmented step (``segmented_step="on"``), as its own test does, so that it
compiles in pieces; both chunk the patch views four at a time.

Bar: every step-end latent within MAE 1e-3 and max 1e-2 of the JAX
package's, the port's pipeline bar (tests/test_torch_port_pipeline.py).
Slow (8 to 10 minutes and 36 GB resident in one process on an 8-core
host):
    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_port_full_production.py -m slow -s
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_common import (TORCH_TOY_RUNTIME, _jax_step_latents,
                               _scripted, perturb_tree, port_bundle_config,
                               t2n)

from elasticdiffusion_tpu import configs as jcfg
from elasticdiffusion_tpu.models.registry import load_bundle as j_load_bundle
from elasticdiffusion_tpu.ops.resample import build_resample_plan
from elasticdiffusion_tpu_torch.models.convert import (
    clip_from_jax, unet_from_jax, vae_from_jax)
from elasticdiffusion_tpu_torch.models.registry import load_bundle

REQUEST = dict(height=512, width=768, num_inference_steps=2,
               guidance_scale=10.0, resampling_steps=7, new_p=0.3,
               rrg_init_weight=1000.0, rrg_stop_t=0.0, cosine_scale=3.0,
               repaint_sampling=True)
PROMPT = "a photo of the dolomites"
VIEW_BATCH = 4


def _bundles():
    """(JAX SD 1.5 bundle, port SD 1.5 bundle), fp32, every JAX leaf
    perturbed and carried across."""
    runtime = jcfg.RuntimeConfig(param_dtype=jnp.float32,
                                 compute_dtype=jnp.float32, use_pallas="off",
                                 segmented_step="on")
    cfg = jcfg.get_bundle_config("1.5")
    jb = j_load_bundle("1.5", runtime=runtime, bundle_config=cfg)
    rng = np.random.default_rng(60)
    tb = load_bundle("1.5", TORCH_TOY_RUNTIME,
                     bundle_config=port_bundle_config(cfg), device="cpu")
    unet = perturb_tree(jb.unet_params, rng)
    tb.unet.load_state_dict(unet_from_jax(unet))
    jb.unet_params = jax.tree.map(jnp.asarray, unet)
    del unet
    vae = perturb_tree(jb.vae_params, rng)
    tb.vae_fp32.load_state_dict(vae_from_jax(vae))
    jb.vae_params = jax.tree.map(jnp.asarray, vae)
    text = tuple(perturb_tree(p, rng) for p in jb.text_params)
    for model, params in zip(tb.text_models, text):
        model.load_state_dict(clip_from_jax(params))
    jb.text_params = tuple(jax.tree.map(jnp.asarray, p) for p in text)
    return jb, tb


@pytest.mark.slow
def test_sd15_production_request_matches_jax(monkeypatch, tmp_path):
    import elasticdiffusion_tpu.core.pipeline as jpipe
    from elasticdiffusion_tpu_torch.core import background as tbg
    from elasticdiffusion_tpu_torch.core.pipeline import ElasticDiffusion

    jb, tb = _bundles()
    jp = jpipe.ElasticDiffusion(bundle=jb, view_batch_size=VIEW_BATCH)
    jp.seed_everything(0)
    tp = ElasticDiffusion(bundle=tb, device="cpu", view_batch_size=VIEW_BATCH)
    tp.seed_everything(0)
    vsf = jb.vae_scale_factor
    H, W = REQUEST["height"] // vsf, REQUEST["width"] // vsf
    plan = build_resample_plan(H, W, *jp.get_downsample_size(
        REQUEST["height"], REQUEST["width"]))
    rng = np.random.default_rng(0)
    init = rng.standard_normal((1, 4, H, W)).astype(np.float32)
    kw = dict(REQUEST, latents=init, scripted_noise=_scripted(
        rng, REQUEST["num_inference_steps"], REQUEST["resampling_steps"],
        plan.num_blocks, (1, 4, H, W), True))

    recorded = []
    make = jpipe.make_background_table
    monkeypatch.setattr(jpipe, "make_background_table", lambda *a, **k: (
        recorded.append(make(*a, **k)), recorded[-1])[1])
    jimg, jlats = _jax_step_latents(jp, tmp_path, [PROMPT], **kw)
    assert recorded, "512x768 pads the downsampled latent with backgrounds"
    replay = iter(recorded)
    monkeypatch.setattr(tbg, "make_background_table", lambda *a, **k: {
        s: torch.tensor(np.asarray(v)) for s, v in next(replay).items()})
    timg, _ = tp.generate_image([PROMPT], return_arrays=True, **kw)
    tlats = [t2n(l) for l in tp.last_step_latents]

    assert len(jlats) == len(tlats) == REQUEST["num_inference_steps"]
    assert tp.last_metrics["unet_view_forwards"] \
        == jp.last_metrics["unet_view_forwards"]
    for i, (a, b) in enumerate(zip(tlats, jlats)):
        d = np.abs(a - np.asarray(b))
        print(f"FULL_WIDTH production_step{i} mae={float(d.mean())!r} "
              f"max_abs={float(d.max())!r} bar=mae 1e-3 max 1e-2 "
              f"latent_mean_abs={float(np.abs(np.asarray(b)).mean())!r}")
        assert d.mean() < 1e-3 and d.max() < 1e-2, (i, d.mean(), d.max())
    assert timg.shape == np.asarray(jimg).shape == (1, 3, 512, 768)
    assert np.isfinite(timg).all()
    print(f"FULL_WIDTH production_image max_abs="
          f"{float(np.abs(timg - np.asarray(jimg)).max())!r} bar=none")
