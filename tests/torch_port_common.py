"""Shared helpers of the port's CPU tests (tests/test_torch_port_*.py).

Both packages are imported here and only here and in the tests: the port
itself never imports jax or the JAX package. Inputs are numpy arrays made
from a seed; weights are carried from the JAX toy bundle into the port's
modules through models/convert.py.
"""

import dataclasses
import functools

import jax
import numpy as np
import torch

from toy_configs import make_toy_bundle

from elasticdiffusion_tpu_torch import configs as tcfg
from elasticdiffusion_tpu_torch.models.convert import (
    clip_from_jax, unet_from_jax, vae_from_jax)
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


@functools.lru_cache(maxsize=1)
def toy_bundles():
    """(JAX toy SD bundle, the port's bundle on the CPU with its weights)."""
    jb = make_toy_bundle()
    tb = load_bundle("toy", TORCH_TOY_RUNTIME,
                     bundle_config=port_bundle_config(jb.config), device="cpu")
    tb.unet.load_state_dict(unet_from_jax(to_numpy_tree(jb.unet_params)))
    tb.vae_fp32.load_state_dict(vae_from_jax(to_numpy_tree(jb.vae_params)))
    tb.text_models[0].load_state_dict(
        clip_from_jax(to_numpy_tree(jb.text_params[0])))
    return jb, tb


def t2n(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def max_abs(a, b) -> float:
    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max())
