"""Weights carried across from the JAX package's parameter trees.

``unet_from_jax``, ``vae_from_jax`` and ``clip_from_jax`` take a parameter
pytree of the JAX package (nested dicts whose leaves are numpy-convertible
arrays) and return a ``state_dict`` for the port's module of the same model.
They reverse the layout transforms of the JAX package's checkpoint converter

  conv   flax (kh, kw, I, O) -> torch (O, I, kh, kw)
  linear flax (I, O)         -> torch (O, I)
  norms  scale / bias        -> weight / bias

and its Flax names (``GroupNorm_0/scale``, ``blocks_{i}``, ``to_out``, ...).
The port's modules are named after the diffusers / transformers checkpoint
keys, so the result carries exactly those keys: a later loader of real
checkpoints needs no renaming at all.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch


def _flatten(tree: Dict[str, Any], prefix=()) -> Iterator[Tuple[tuple, Any]]:
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _leaf(name: str, value) -> Tuple[str, torch.Tensor]:
    """Flax leaf name and array -> torch parameter name and tensor."""
    a = np.asarray(value)
    if name == "kernel":
        a = a.transpose(3, 2, 0, 1) if a.ndim == 4 else a.transpose(1, 0)
        name = "weight"
    elif name in ("scale", "embedding"):
        name = "weight"
    return name, torch.tensor(np.ascontiguousarray(a))


def _resnet(rest: tuple) -> str:
    # norm1/GroupNorm_0/scale -> norm1 ; conv1/kernel -> conv1
    return rest[0]


def _attention(rest: tuple) -> str:
    return "to_out.0" if rest[0] == "to_out" else rest[0]


def _transformer(rest: tuple) -> str:
    head = rest[0]
    if head in ("norm", "proj_in", "proj_out"):
        return head
    m = re.fullmatch(r"blocks_(\d+)", head)
    if not m:
        raise KeyError(f"unknown transformer entry {rest}")
    blk = f"transformer_blocks.{m.group(1)}"
    sub = rest[1]
    if sub in ("norm1", "norm2", "norm3"):
        return f"{blk}.{sub}"
    if sub in ("attn1", "attn2"):
        return f"{blk}.{sub}.{_attention(rest[2:])}"
    if sub == "ff":
        return f"{blk}.ff." + {"proj_in": "net.0.proj",
                               "proj_out": "net.2"}[rest[2]]
    raise KeyError(f"unknown transformer block entry {rest}")


def _unet_module(path: tuple, n_blocks: int) -> str:
    head, rest = path[0], path[1:]
    if head in ("conv_in", "conv_out", "conv_norm_out"):
        return head
    if head in ("time_embedding", "add_embedding"):
        return f"{head}.{rest[0]}"
    m = re.fullmatch(r"mid_resnet_(\d)", head)
    if m:
        return f"mid_block.resnets.{m.group(1)}.{_resnet(rest)}"
    if head == "mid_attn":
        return f"mid_block.attentions.0.{_transformer(rest)}"
    m = re.fullmatch(r"(down|up)_(\d+)_(downsample|upsample)", head)
    if m:
        side, i = m.group(1), int(m.group(2))
        blk = i if side == "down" else n_blocks - 1 - i
        return f"{side}_blocks.{blk}.{m.group(3)}rs.0.conv"
    m = re.fullmatch(r"(down|up)_(\d+)_(\d+)(_resnet)?", head)
    if m:
        side, i, j = m.group(1), int(m.group(2)), m.group(3)
        blk = i if side == "down" else n_blocks - 1 - i
        if m.group(4):  # attention-free block: the resnet sits at top level
            return f"{side}_blocks.{blk}.resnets.{j}.{_resnet(rest)}"
        if rest[0] == "resnet":
            return f"{side}_blocks.{blk}.resnets.{j}.{_resnet(rest[1:])}"
        if rest[0] == "attn":
            return f"{side}_blocks.{blk}.attentions.{j}.{_transformer(rest[1:])}"
    raise KeyError(f"unknown UNet entry {path}")


def unet_from_jax(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX UNet2DCondition params -> state_dict of the port's UNet."""
    n_blocks = 1 + max(int(m.group(1)) for k in tree
                       if (m := re.match(r"down_(\d+)_", k)))
    out = {}
    for path, value in _flatten(tree):
        name, tensor = _leaf(path[-1], value)
        out[f"{_unet_module(path[:-1], n_blocks)}.{name}"] = tensor
    return out


def _vae_module(path: tuple) -> str:
    side, head, rest = path[0], path[1], path[2:]
    if head in ("conv_in", "conv_out", "conv_norm_out"):
        return f"{side}.{head}"
    m = re.fullmatch(r"mid_resnet_(\d)", head)
    if m:
        return f"{side}.mid_block.resnets.{m.group(1)}.{_resnet(rest)}"
    if head == "mid_attn":
        sub = "group_norm" if rest[0] == "group_norm" else _attention(rest[1:])
        return f"{side}.mid_block.attentions.0.{sub}"
    m = re.fullmatch(r"(down|up)_(\d+)_(downsample|upsample)", head)
    if m:
        return f"{side}.{m.group(1)}_blocks.{m.group(2)}.{m.group(3)}rs.0.conv"
    m = re.fullmatch(r"(down|up)_(\d+)_(\d+)", head)
    if m:
        return (f"{side}.{m.group(1)}_blocks.{m.group(2)}.resnets."
                f"{m.group(3)}.{_resnet(rest)}")
    raise KeyError(f"unknown VAE entry {path}")


def vae_from_jax(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX AutoencoderKL params -> state_dict of the port's AutoencoderKL."""
    out = {}
    for path, value in _flatten(tree):
        name, tensor = _leaf(path[-1], value)
        if path[0] in ("quant_conv", "post_quant_conv"):
            out[f"{path[0]}.{name}"] = tensor
        else:
            out[f"{_vae_module(path[:-1])}.{name}"] = tensor
    return out


def clip_from_jax(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX CLIPTextModel params -> state_dict of the port's CLIPTextModel."""
    out = {}
    for path, value in _flatten(tree):
        head = path[0]
        if head == "position_embedding":  # a bare array in the JAX tree
            out["text_model.embeddings.position_embedding.weight"] = \
                torch.tensor(np.asarray(value))
            continue
        name, tensor = _leaf(path[-1], value)
        m = re.fullmatch(r"layers_(\d+)", head)
        if m:
            sub = path[1]
            if sub in ("q_proj", "k_proj", "v_proj", "out_proj"):
                sub = f"self_attn.{sub}"
            elif sub in ("fc1", "fc2"):
                sub = f"mlp.{sub}"
            key = f"text_model.encoder.layers.{m.group(1)}.{sub}"
        elif head == "token_embedding":
            key = "text_model.embeddings.token_embedding"
        elif head == "final_layer_norm":
            key = "text_model.final_layer_norm"
        elif head == "text_projection":
            key = "text_projection"
        else:
            raise KeyError(f"unknown CLIP entry {path}")
        out[f"{key}.{name}"] = tensor
    return out
