"""DPT monocular depth estimation, the depth condition of the ControlNet path.

Counterpart of ``elasticdiffusion_tpu/models/dpt.py``: a ViT backbone with
hooked intermediate layers, the DPT reassemble / fusion neck and the depth
head of ``transformers.DPTForDepthEstimation`` (non-hybrid, readout
'project'). Modules are named after that checkpoint's keys (``dpt.encoder.
layer.{i}``, ``neck.fusion_stage.layers.{j}``, ``head.head.{k}``), except that
the first fusion layer has no ``residual_layer1``: it never runs.

The JAX package computes all of it outside any Pallas kernel (its attention
is an einsum and a softmax, its LayerNorms XLA's), so here it is plain
PyTorch in fp32 and launches none of the port's kernels. Tensors are NCHW.
``load_dpt`` reads a transformers ``DPTForDepthEstimation`` directory
(``config.json`` and its weights, e.g. Intel/dpt-large) into it by name.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.resize import linear_resize
from .convert import hf_to_port, load_into, load_state_dict
from .registry import build_seeded, resolve_device


@dataclass(frozen=True)
class DPTDepthConfig:
    """transformers.DPTConfig, the non-hybrid subset."""

    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    intermediate_size: int = 4096
    patch_size: int = 16
    image_size: int = 384  # the position embeddings' native grid is 384/16
    backbone_out_indices: Tuple[int, ...] = (5, 11, 17, 23)
    neck_hidden_sizes: Tuple[int, ...] = (256, 512, 1024, 1024)
    reassemble_factors: Tuple[float, ...] = (4, 2, 1, 0.5)
    fusion_hidden_size: int = 256
    layer_norm_eps: float = 1e-12


DPT_LARGE = DPTDepthConfig()  # Intel/dpt-large

# the DPT image processor's normalisation
DPT_MEAN = (0.5, 0.5, 0.5)
DPT_STD = (0.5, 0.5, 0.5)


def _node(**children) -> nn.Module:
    """A module that only names its children (checkpoint key levels)."""
    m = nn.Module()
    for k, v in children.items():
        setattr(m, k, v)
    return m


def _vit_layer(c: DPTDepthConfig) -> nn.Module:
    D = c.hidden_size
    return _node(
        layernorm_before=nn.LayerNorm(D, eps=c.layer_norm_eps),
        attention=_node(attention=_node(query=nn.Linear(D, D),
                                        key=nn.Linear(D, D),
                                        value=nn.Linear(D, D)),
                        output=_node(dense=nn.Linear(D, D))),
        layernorm_after=nn.LayerNorm(D, eps=c.layer_norm_eps),
        intermediate=_node(dense=nn.Linear(D, c.intermediate_size)),
        output=_node(dense=nn.Linear(c.intermediate_size, D)))


def _vit_forward(layer: nn.Module, x: torch.Tensor, heads: int) -> torch.Tensor:
    B, S, D = x.shape
    att = layer.attention.attention
    h = layer.layernorm_before(x)
    q, k, v = (p(h).view(B, S, heads, D // heads)
               for p in (att.query, att.key, att.value))
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) / (D // heads) ** 0.5
    out = torch.einsum("bhqk,bkhd->bqhd", logits.softmax(-1), v)
    x = x + layer.attention.output.dense(out.reshape(B, S, D))
    h = F.gelu(layer.intermediate.dense(layer.layernorm_after(x)))
    return x + layer.output.dense(h)


def _pre_act(features: int) -> nn.Module:
    return _node(convolution1=nn.Conv2d(features, features, 3, padding=1),
                 convolution2=nn.Conv2d(features, features, 3, padding=1))


def _pre_act_forward(m: nn.Module, x: torch.Tensor) -> torch.Tensor:
    h = m.convolution1(F.relu(x))
    return x + m.convolution2(F.relu(h))


def _upsample2(x: torch.Tensor) -> torch.Tensor:
    return F.interpolate(x, scale_factor=2.0, mode="bilinear",
                         align_corners=True)


class DPTDepthModel(nn.Module):
    """pixel_values (B, 3, H, W), normalised -> predicted depth (B, H, W)."""

    def __init__(self, config: DPTDepthConfig = DPT_LARGE):
        super().__init__()
        self.config = c = config
        D, p, fh = c.hidden_size, c.patch_size, c.fusion_hidden_size
        g0 = c.image_size // p
        self.dpt = _node(
            embeddings=_node(
                cls_token=nn.Parameter(torch.zeros(1, 1, D)),
                position_embeddings=nn.Parameter(
                    torch.zeros(1, g0 * g0 + 1, D)),
                patch_embeddings=_node(
                    projection=nn.Conv2d(3, D, p, stride=p))),
            encoder=_node(layer=nn.ModuleList(
                _vit_layer(c) for _ in range(c.num_layers))))

        layers = []
        for nh, fac in zip(c.neck_hidden_sizes, c.reassemble_factors):
            if fac > 1:
                resize = nn.ConvTranspose2d(nh, nh, int(fac), stride=int(fac))
            elif fac < 1:
                resize = nn.Conv2d(nh, nh, 3, stride=int(round(1 / fac)),
                                   padding=1)
            else:
                resize = nn.Identity()
            layers.append(_node(projection=nn.Conv2d(D, nh, 1), resize=resize))
        fusion = []
        for j in range(len(c.neck_hidden_sizes)):
            f = _node(projection=nn.Conv2d(fh, fh, 1),
                      residual_layer2=_pre_act(fh))
            if j > 0:
                f.residual_layer1 = _pre_act(fh)
            fusion.append(f)
        self.neck = _node(
            reassemble_stage=_node(
                readout_projects=nn.ModuleList(
                    nn.Sequential(nn.Linear(2 * D, D), nn.GELU())
                    for _ in c.neck_hidden_sizes),
                layers=nn.ModuleList(layers)),
            convs=nn.ModuleList(nn.Conv2d(nh, fh, 3, padding=1, bias=False)
                                for nh in c.neck_hidden_sizes),
            fusion_stage=_node(layers=nn.ModuleList(fusion)))
        self.head = _node(head=nn.Sequential(
            nn.Conv2d(fh, fh // 2, 3, padding=1),
            nn.Upsample(scale_factor=2.0, mode="bilinear", align_corners=True),
            nn.Conv2d(fh // 2, 32, 3, padding=1), nn.ReLU(),
            nn.Conv2d(32, 1, 1), nn.ReLU()))

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        c = self.config
        p, D = c.patch_size, c.hidden_size
        B, _, H, W = pixel_values.shape
        if H % p or W % p:
            raise ValueError(f"input {H}x{W} must be a multiple of {p}")
        gh, gw = H // p, W // p
        emb = self.dpt.embeddings
        x = emb.patch_embeddings.projection(pixel_values.float())
        x = x.flatten(2).transpose(1, 2)                      # (B, gh*gw, D)
        g0 = c.image_size // p
        pos = emb.position_embeddings
        grid = pos[0, 1:].reshape(g0, g0, D).permute(2, 0, 1)
        grid = linear_resize(grid, (gh, gw)).permute(1, 2, 0).reshape(1, -1, D)
        h = torch.cat([emb.cls_token.expand(B, 1, D), x], dim=1) \
            + torch.cat([pos[:, :1], grid], dim=1)

        hooked = {}
        for i, layer in enumerate(self.dpt.encoder.layer):
            h = _vit_forward(layer, h, c.num_heads)
            if i in c.backbone_out_indices:
                hooked[i] = h

        neck = self.neck
        feats = []
        for j, idx in enumerate(c.backbone_out_indices):
            cls_t, tok = hooked[idx][:, :1], hooked[idx][:, 1:]
            tok = neck.reassemble_stage.readout_projects[j](
                torch.cat([tok, cls_t.expand_as(tok)], dim=-1))
            f = tok.transpose(1, 2).reshape(B, D, gh, gw)
            layer = neck.reassemble_stage.layers[j]
            f = layer.resize(layer.projection(f))
            feats.append(neck.convs[j](f))

        fused = None
        for layer, f in zip(neck.fusion_stage.layers, reversed(feats)):
            if fused is None:
                x = f
            else:
                x = fused
                if f.shape[-2:] != x.shape[-2:]:
                    f = linear_resize(f, x.shape[-2:])
                x = x + _pre_act_forward(layer.residual_layer1, f)
            x = _upsample2(_pre_act_forward(layer.residual_layer2, x))
            fused = layer.projection(x)

        return self.head.head(fused)[:, 0]


def random_dpt(config: DPTDepthConfig = DPT_LARGE, generator=None,
               device="cuda") -> DPTDepthModel:
    """A DPT with seeded random weights (``models/registry.py``'s init; the
    class token and position embeddings zero, as Flax's init gives them)."""
    dev = resolve_device(device)
    gen = generator if generator is not None else \
        torch.Generator(device=dev).manual_seed(0)
    model = build_seeded(lambda: DPTDepthModel(config), dev, gen)
    with torch.no_grad():
        model.dpt.embeddings.cls_token.zero_()
        model.dpt.embeddings.position_embeddings.zero_()
    return model


def dpt_config(model_dir: str) -> DPTDepthConfig:
    """The config of a transformers DPT directory (its ``config.json``;
    DPT-large's values where it is absent or silent). Only the non-hybrid
    DPT with readout 'project' is built."""
    path = os.path.join(model_dir, "config.json")
    if not os.path.isfile(path):
        return DPT_LARGE
    with open(path) as f:
        c = json.load(f)
    if c.get("is_hybrid") or c.get("readout_type", "project") != "project":
        raise ValueError(f"{model_dir}: only the non-hybrid DPT with readout "
                         f"'project' is supported")
    d = DPT_LARGE
    return DPTDepthConfig(
        hidden_size=c.get("hidden_size", d.hidden_size),
        num_layers=c.get("num_hidden_layers", d.num_layers),
        num_heads=c.get("num_attention_heads", d.num_heads),
        intermediate_size=c.get("intermediate_size", d.intermediate_size),
        patch_size=c.get("patch_size", d.patch_size),
        image_size=c.get("image_size", d.image_size),
        backbone_out_indices=tuple(c.get("backbone_out_indices",
                                         d.backbone_out_indices)),
        neck_hidden_sizes=tuple(c.get("neck_hidden_sizes",
                                      d.neck_hidden_sizes)),
        reassemble_factors=tuple(c.get("reassemble_factors",
                                       d.reassemble_factors)),
        fusion_hidden_size=c.get("fusion_hidden_size", d.fusion_hidden_size),
        layer_norm_eps=c.get("layer_norm_eps", d.layer_norm_eps))


def load_dpt(model_dir: str, device="cuda") -> DPTDepthModel:
    """A transformers ``DPTForDepthEstimation`` directory as the port's DPT
    on `device`, loaded by name and strictly (``convert.load_into``). The
    transposed convolutions take transformers' weights as they are: both
    are ``ConvTranspose2d``."""
    if not os.path.isdir(model_dir):
        raise FileNotFoundError(f"no DPT directory at {model_dir}")
    dev = resolve_device(device)
    with torch.device("meta"):
        model = DPTDepthModel(dpt_config(model_dir))
    model = model.to_empty(device=dev).eval().requires_grad_(False)
    load_into(model, hf_to_port(load_state_dict(model_dir, dev), "dpt"),
              f"DPT in {model_dir}")
    return model


def make_depth_fn(model: DPTDepthModel, proc_size: int = 384):
    """depth_fn(image) -> (H, W) float32 depth map, the hook that
    ``apps/preprocessors.process_condition_image`` calls. As the
    transformers pipeline: resize to proc_size, normalise with mean and std
    0.5, predict, resize back to the input's size (both resizes
    ``linear_resize``, the JAX package's ``jax.image.resize`` 'linear')."""
    dev = next(model.parameters()).device

    @torch.no_grad()
    def depth_fn(image) -> np.ndarray:
        arr = np.asarray(image, dtype=np.float32)
        if arr.max() > 1.5:
            arr = arr / 255.0
        if arr.ndim == 2:
            arr = np.stack([arr] * 3, axis=-1)
        h0, w0 = arr.shape[:2]
        x = torch.from_numpy(np.ascontiguousarray(arr.transpose(2, 0, 1)))
        x = linear_resize(x.to(dev), (proc_size, proc_size))
        mean = torch.tensor(DPT_MEAN, device=dev)[:, None, None]
        std = torch.tensor(DPT_STD, device=dev)[:, None, None]
        d = model(((x - mean) / std)[None])[0]
        return linear_resize(d, (h0, w0)).cpu().numpy()

    return depth_fn
