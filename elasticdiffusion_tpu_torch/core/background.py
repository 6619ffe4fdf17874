"""Denoised-background padding.

When a UNet input is smaller than the model's native latent size, it is
padded with a VAE-encoded solid random colour, forward-noised to the current
timestep. Padding order is W first (ids '3_1' / '3_2'), then H over the
already W-padded width (ids '2_1' / '2_2').

All backgrounds are computed once per generate call for every (pad shape,
timestep) pair, stacked as (T, C, ph, pw) tensors, and indexed inside the
step. Colour and noise of one (side, t) pair come from a torch.Generator
seeded from (seed, md5 of the side id, t), so they do not depend on the
order of the calls. The numbers differ from the JAX package's jax.random
draws: parity tests hand the port the JAX package's tables.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np
import torch


def string_to_number(s: str, num_bytes: int = 4) -> int:
    """md5-prefix hash of a side id."""
    return int(hashlib.md5(s.encode()).hexdigest()[:num_bytes * 2], 16)


@dataclass(frozen=True)
class PadSpec:
    """Padding of one input shape up to the model minimum."""

    in_h: int
    in_w: int
    min_h: int
    min_w: int

    @property
    def pads(self) -> Tuple[int, int, int, int]:
        h_p = max(self.min_h - self.in_h, 0)
        w_p = max(self.min_w - self.in_w, 0)
        return (w_p // 2, w_p - w_p // 2, h_p // 2, h_p - h_p // 2)  # l, r, t, b

    @property
    def needs_padding(self) -> bool:
        return any(p > 0 for p in self.pads)

    @property
    def out_shape(self) -> Tuple[int, int]:
        l, r, t, b = self.pads
        return (self.in_h + t + b, self.in_w + l + r)

    def side_shapes(self) -> Dict[str, Tuple[int, int]]:
        """Background rectangles in padding order: W pads at input height,
        then H pads at padded width (id scheme '3_*' = W axis, '2_*' = H)."""
        l, r, t, b = self.pads
        out = {}
        if l:
            out["3_1"] = (self.in_h, l)
        if r:
            out["3_2"] = (self.in_h, r)
        w_padded = self.in_w + l + r
        if t:
            out["2_1"] = (t, w_padded)
        if b:
            out["2_2"] = (b, w_padded)
        return out


def make_background_table(bundle, timesteps: np.ndarray, spec: PadSpec,
                          seed: int, scheduler) -> Dict[str, torch.Tensor]:
    """Precompute noised backgrounds for every (side, t) of one PadSpec.

    Returns {side_id: (T, C, ph, pw)} float32 tensors on the bundle's device.
    """
    dev = bundle.device
    vsf = bundle.vae_scale_factor
    scaling = bundle.config.vae.scaling_factor
    lat_ch = bundle.config.vae.latent_channels
    tables: Dict[str, torch.Tensor] = {}
    for side, (ph, pw) in spec.side_shapes().items():
        sid = string_to_number(f"{side}_{ph}_{pw}")
        rows = []
        for t in timesteps:
            t = int(t)
            gen = torch.Generator(device=dev).manual_seed(
                (int(seed) * 1000003 + sid * 1009 + t) % (2 ** 63))
            color = torch.rand((1, 3, 1, 1), generator=gen, device=dev)
            color = color.expand(1, 3, ph * vsf, pw * vsf)
            enc_noise = torch.randn((1, lat_ch, ph, pw), generator=gen,
                                    device=dev)
            # colour in [0,1] -> VAE input in [-1,1]
            bg = bundle.vae_encode_sample(2.0 * color - 1.0, enc_noise) * scaling
            noise = torch.randn(bg.shape, generator=gen, device=dev)
            a, b = scheduler.add_noise_coeffs(t)
            rows.append((a * bg + b * noise)[0])
        tables[side] = torch.stack(rows)  # (T, C, ph, pw)
    return tables


def pad_with_background(x: torch.Tensor, spec: PadSpec,
                        bgs: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Pad (B, C, h, w) -> (B, C, out_h, out_w) with this step's backgrounds.

    bgs: {side: (C, ph, pw)} for the CURRENT timestep (already indexed).
    Each side uses the same background for the whole batch.
    """
    if not spec.needs_padding:
        return x
    B = x.shape[0]
    rep = lambda a: a.to(x.dtype)[None].expand(B, *a.shape)
    l, r, t, b = spec.pads
    if l:
        x = torch.cat([rep(bgs["3_1"]), x], dim=3)
    if r:
        x = torch.cat([x, rep(bgs["3_2"])], dim=3)
    if t:
        x = torch.cat([rep(bgs["2_1"]), x], dim=2)
    if b:
        x = torch.cat([x, rep(bgs["2_2"])], dim=2)
    return x


def crop_from_padding(x: torch.Tensor, spec: PadSpec) -> torch.Tensor:
    l, r, t, b = spec.pads
    H, W = x.shape[-2], x.shape[-1]
    return x[..., t:H - b, l:W - r]
