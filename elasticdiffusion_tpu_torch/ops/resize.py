"""Corner-aligned nearest resize.

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
