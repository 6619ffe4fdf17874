"""Seeded random weights in the checkpoints' own names (diffusers /
transformers), made on the device in the dtype each model is served in.

Both sides read them: the harness hands them to the program through its
checkpoint converter, and the reference loads them into its plain models.
Matrices and convolution kernels are N(0, 1/fan_in), embeddings
N(0, 0.02^2); biases 0.1 N(0, 1) and norm weights 1 + 0.1 N(0, 1), so that a
bias or a norm parameter wired to the wrong place changes the answer. One
``randn`` a model, scaled leaf by leaf in place.
"""

from __future__ import annotations

from typing import Dict

import torch

from .reference import models as M
from .reference.elastic import fold, text_encoders

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def checkpoint_models(cfg: dict) -> Dict[str, torch.nn.Module]:
    """{checkpoint name: reference model on the meta device}, in the order
    the weights are drawn: a ControlNet last, so that the other models'
    weights are the same bits with it or without it."""
    out = {"unet": M.build("unet", cfg["unet"]), "vae": M.build("vae", cfg["vae"])}
    for name, c in text_encoders(cfg):
        out[name] = M.build("clip", c)
    if "controlnet" in cfg:
        out["controlnet"] = M.build("controlnet", cfg["controlnet"])
    return out


def served_dtype(cfg: dict, name: str) -> torch.dtype:
    """The dtype a model's weights are served in (the config's
    ``dtypes``): the VAE's fp32 masters; the others' as the config states."""
    key = "text_encoder" if name.startswith("text_encoder") else name
    return DTYPES[cfg["dtypes"][key]]


def _scale(name: str, shape) -> tuple:
    """(multiplier, offset) of a leaf's N(0, 1) draw."""
    if name.startswith("text_model.embeddings."):
        return 0.02, 0.0
    if len(shape) >= 2:
        fan_in = 1
        for s in shape[1:]:
            fan_in *= s
        return fan_in ** -0.5, 0.0
    if name.endswith(".bias"):
        return 0.1, 0.0
    return 0.1, 1.0  # a norm weight


@torch.no_grad()
def make_weights(cfg: dict, seed: int, device) -> Dict[str, Dict[str, torch.Tensor]]:
    """{checkpoint name: {parameter name: tensor}} from `seed`; the same
    seed gives the same weights."""
    out = {}
    for k, (name, model) in enumerate(checkpoint_models(cfg).items()):
        shapes = {n: tuple(p.shape) for n, p in model.state_dict().items()}
        total = sum(torch.Size(s).numel() for s in shapes.values())
        gen = torch.Generator(device=device).manual_seed(fold(seed, 100 + k))
        flat = torch.randn(total, generator=gen, device=device,
                           dtype=served_dtype(cfg, name))
        sd, off = {}, 0
        for n, s in shapes.items():
            numel = torch.Size(s).numel()
            t = flat[off:off + numel].view(s)
            mul, add = _scale(n, s)
            t.mul_(mul)
            if add:
                t.add_(add)
            sd[n] = t
            off += numel
        out[name] = sd
    return out
