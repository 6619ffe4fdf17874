"""Corner-aligned nearest resize, and the 'linear' resize of jax.image.

torch's F.interpolate(mode='nearest') picks the source pixel at
floor(i * in/out) (top-left alignment); optional H/W flips select which
corner of the block the sample aligns to ('bottom' / 'right' flags).

The index vectors are computed on the host with numpy in float64, exactly as
the JAX package computes them, and the device op is one separable gather.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def nearest_indices(in_size: int, out_size: int, flip: bool = False) -> np.ndarray:
    """Source index for each output position, exact torch 'nearest' semantics."""
    idx = np.floor(np.arange(out_size) * (in_size / out_size)).astype(np.int64)
    idx = np.minimum(idx, in_size - 1)
    if flip:
        # flip input, sample, flip back == sample at mirrored indices:
        # out[i] = in[(in-1) - idx[(out-1) - i]]
        idx = ((in_size - 1) - idx[::-1]).copy()
    return idx


@functools.lru_cache(maxsize=256)
def _device_indices(in_size: int, out_size: int, flip: bool, device: str):
    return torch.from_numpy(nearest_indices(in_size, out_size, flip)).to(device)


def nearest_resize(x: torch.Tensor, size, bottom: bool = False,
                   right: bool = False) -> torch.Tensor:
    """Nearest resize of an NCHW (or ...HW) tensor to `size` = (H, W).

    `bottom` / `right` choose the bottom / right pixel of each source block.
    """
    H_out, W_out = int(size[0]), int(size[1])
    H_in, W_in = x.shape[-2], x.shape[-1]
    if (H_in, W_in) == (H_out, W_out):
        return x
    rows = _device_indices(H_in, H_out, bottom, str(x.device))
    cols = _device_indices(W_in, W_out, right, str(x.device))
    return x.index_select(-2, rows).index_select(-1, cols)


def linear_weights(in_size: int, out_size: int) -> np.ndarray:
    """(in_size, out_size) float32 weights of a 'linear' resize along one
    axis, the triangle kernel of ``jax.image.resize(method='linear')``:
    half-pixel centres, the kernel widened by in/out when shrinking (it
    antialiases), each output's weights summed to 1 over the input."""
    inv_scale = np.float32(1.0 / (out_size / in_size))  # jax's rounding
    kernel_scale = max(inv_scale, np.float32(1.0))
    sample = ((np.arange(out_size, dtype=np.float32) + np.float32(0.5))
              * inv_scale - np.float32(0.5))
    x = np.abs(sample[None, :] - np.arange(in_size, dtype=np.float32)[:, None])
    w = np.maximum(np.float32(0.0), np.float32(1.0) - x / kernel_scale)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, 1), 0.0)
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.where(inside[None, :], w, 0.0).astype(np.float32)


def linear_resize(x: torch.Tensor, size) -> torch.Tensor:
    """Resize the last two axes of `x` to `size` = (H, W) as
    ``jax.image.resize(..., method='linear')`` does: separable products with
    ``linear_weights`` (``F.interpolate`` neither antialiases the same way
    nor normalises at the borders as it does)."""
    wh = torch.from_numpy(linear_weights(x.shape[-2], int(size[0])))
    ww = torch.from_numpy(linear_weights(x.shape[-1], int(size[1])))
    wh, ww = wh.to(x.device, x.dtype), ww.to(x.device, x.dtype)
    return torch.einsum("...hw,hi,wj->...ij", x, wh, ww)
