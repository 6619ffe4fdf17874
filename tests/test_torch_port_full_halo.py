"""The port's large-size decodes on the full SD VAE, held to the JAX package.

The JAX package's slow tier holds its streamed stage b to its monolithic one
(tests/test_halo_decode.py:105) and its mesh decode to the monolithic
functional decode (:69) at the full SD VAE architecture (128/256/512/512);
the port's own branch tests (tests/test_torch_port_halo_decode.py,
tests/test_torch_port_mesh.py) run only the toy VAE. Here both packages
decode with the full SD VAE on the same weights: the ``TorchVAE`` mirror of
tests/test_whole_model_goldens.py, seeded, carried into JAX by
``convert_vae`` and into the port by ``hf_to_port`` and ``load_into``. The
bundles around it are the toy bundles with the full VAE in the place of
theirs (only the VAE runs). fp32 on the CPU; the JAX side with
``use_pallas="off"``.

Bars: the same branch in both packages within 3e-5, the bar of
tests/test_torch_port_halo_decode.py; the port's mesh decode on two gloo
ranks (spawned processes, tests/torch_port_mesh_worker.py) within atol 1e-4,
rtol 1e-3 of the JAX monolithic functional decode, the bar of
tests/test_halo_decode.py:69, and the ranks bitwise equal. Each test prints
its largest absolute error (``FULL_WIDTH`` lines; ``pytest -s``). All slow:
    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_port_full_halo.py -m slow -s
"""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_mesh_worker as worker
from test_whole_model_goldens import TorchVAE
from toy_configs import TOY_RUNTIME, toy_bundle_config
from torch_port_common import (TORCH_TOY_RUNTIME, max_abs, port_bundle_config,
                               report, t2n, to_numpy_tree)

from elasticdiffusion_tpu import configs as jcfg
from elasticdiffusion_tpu.models.convert import convert_vae
from elasticdiffusion_tpu.models.registry import load_bundle as j_load_bundle
from elasticdiffusion_tpu.parallel import halo_decode as jhd
from elasticdiffusion_tpu_torch.models.convert import hf_to_port, load_into
from elasticdiffusion_tpu_torch.models.registry import load_bundle
from elasticdiffusion_tpu_torch.parallel import halo_decode as thd

TOL = 3e-5


@functools.lru_cache(maxsize=1)
def full_vae_bundles():
    """(JAX bundle, port bundle): the toy bundles with the full SD VAE,
    loaded in both with the mirror's seeded state dict."""
    cfg = dataclasses.replace(toy_bundle_config(), vae=jcfg.VAEConfig())
    torch.manual_seed(17)
    sd = TorchVAE(cfg.vae).eval().state_dict()
    jb = j_load_bundle(cfg.sd_version, runtime=TOY_RUNTIME, bundle_config=cfg)
    jb.vae_params = convert_vae({k: v.numpy() for k, v in sd.items()},
                                cfg.vae)
    tb = load_bundle(cfg.sd_version, TORCH_TOY_RUNTIME,
                     bundle_config=port_bundle_config(cfg), device="cpu")
    load_into(tb.vae_fp32, hf_to_port(sd, "vae"), "vae")
    assert jb.vae_scale_factor == tb.vae_scale_factor == 8
    return jb, tb


def _latent(seed, h, w):
    rng = np.random.default_rng(seed)
    return (0.5 * rng.standard_normal((1, 4, h, w))).astype(np.float32)


@pytest.mark.slow
@pytest.mark.parametrize("conv", ["native", "onednn"])
@pytest.mark.parametrize("kw", [dict(streamed=True),
                                dict(num_bands=4, halo=12)],
                         ids=["streamed", "bands"])
def test_full_vae_halo_branch_matches_jax(kw, conv):
    """The same branch of halo_decode in both packages on a 32x64 latent
    (256x512 px): the exact streamed stage b, and the sequential bands (4
    bands of 8 latent rows with 12 rows of halo a side: every band's window
    is the whole latent here, as in tests/test_halo_decode.py). The port's
    convolutions run on torch's native CPU convolution, and again on
    oneDNN's (torch's default on this CPU); both on contiguous operands,
    the port's CPU rule (``models/layers.py`` ``conv2d``)."""
    jb, tb = full_vae_bundles()
    z = _latent(7, 32, 64)
    want = np.asarray(jhd.halo_decode(jb, jnp.asarray(z), mesh=None, **kw))
    with torch.backends.mkldnn.flags(enabled=conv == "onednn"):
        got = t2n(thd.halo_decode(tb, torch.from_numpy(z), **kw))
    assert got.shape == want.shape == (1, 3, 256, 512)
    assert np.isfinite(got).all()
    err = max_abs(got, want)
    report(f"halo_{'streamed' if kw.get('streamed') else 'bands'}_{conv}",
           err, f"{TOL}")
    assert err < TOL, err


@pytest.mark.slow
def test_full_vae_mesh_decode_on_two_ranks_matches_jax(tmp_path):
    """The mesh branch of the port on a (1, 2) mesh of two gloo ranks on a
    64x32 latent (512x256 px; each rank decodes 32 latent rows and
    exchanges halo rows and GroupNorm sums) against the JAX package's
    monolithic functional stage b: the exact decode, split."""
    jb, tb = full_vae_bundles()
    z = _latent(8, 64, 32)
    want = np.asarray(jhd.halo_decode(jb, jnp.asarray(z), mesh=None,
                                      num_bands=1))
    spec = {"config": tb.config, "unet": to_numpy_tree(jb.unet_params),
            "vae": to_numpy_tree(jb.vae_params),
            "text": [to_numpy_tree(p) for p in jb.text_params]}
    job = dict(name="halo", kind="halo", bundle="full_vae", mesh=(1, 2),
               latent=z)
    ranks = worker.spawn(2, str(tmp_path), {"full_vae": spec}, [job])
    got = ranks[0]["halo"]["image"]
    assert got.shape == want.shape == (1, 3, 512, 256)
    assert worker.same_everywhere(ranks, "halo", "image")
    assert ranks[0]["halo"]["calls"] == thd.mesh_norm_shapes(
        tb.config.vae, 1, 64, 32, 2)
    report("mesh_decode_1x2", max_abs(got, want), "atol 1e-4 rtol 1e-3")
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-3)
