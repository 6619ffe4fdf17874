"""Randomized rational downsampling for the global-signal estimator.

The reference algorithm chains: nearest 2x upsample -> drop keep/remove
row+col blocks (rational resize to 2*downsample_size) -> random pick of one
pixel of each 2x2 block (exclude-mask rejection sampling + drop_p mixing
with the previous pick) -> track which ORIGINAL pixels were sampled.

Here the whole chain collapses into ONE gather. For output pixel (i,j) with
per-block random index r in [0,4):
    out[i,j] = latent[row_map[2i + r//2], col_map[2j + r%2]]
where row_map[k] = kept_row_indices[k] // 2 composes the 2x upsample with the
block-keep selection. The sampled-pixel mask is an elementwise compare on the
kept grid scattered through the reference-exact restore maps. All index plans
are host-side numpy (shapes are static per generate call); only the random
pick r lives on the device. The NaN-sentinel accumulation of the reference
becomes an explicit (value, filled-mask) pair.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from fractions import Fraction
from typing import Optional, Tuple

import numpy as np
import torch

from .resize import nearest_resize
from .views import PlanTensors


# ---------------------------------------------------------------------------
# Host-side plan construction
# ---------------------------------------------------------------------------


def to_even_rational(f: float, max_block_sz: int = 32) -> Tuple[int, int]:
    """Even numerator/denominator approximation of f."""
    frac = Fraction(f).limit_denominator(max_block_sz)
    if frac.numerator % 2 != 0 or frac.denominator % 2 != 0:
        frac = Fraction(f).limit_denominator(max_block_sz // 2)
    if frac.numerator % 2 != 0 or frac.denominator % 2 != 0:
        return frac.numerator * 2, frac.denominator * 2
    return frac.numerator, frac.denominator


def keep_blocks(block_sz: int, n_remove: int) -> Tuple[np.ndarray, np.ndarray]:
    """Offsets kept within one block of `block_sz` lines after removing
    `n_remove` lines in adjacent pairs, plus the positions (in the kept
    block) where the removal split duplicated pairs."""
    num_pairs = n_remove // 2
    mask = np.ones(block_sz, dtype=bool)
    interval = block_sz // (num_pairs + 1)
    if interval % 2 != 0:
        interval += 1
    masked_positions = []
    for i in range(num_pairs):
        start = (i + 1) * interval - 1
        masked_positions.extend([start - 1 - i * 2, start + 2 - (i + 1) * 2])
        mask[start:start + 2] = False
    return np.nonzero(mask)[0], np.asarray(masked_positions, dtype=np.int64)


def _restore_row_of(n_kept: int, split_positions: np.ndarray) -> np.ndarray:
    """For each kept-grid line k, the original-grid line that the reference's
    restore_mask_shape assigns it to:
    pairs (i, i+1) merge into one line unless the SEQUENTIAL split pointer
    matches i, in which case each maps to its own line.

    Parity quirk preserved: the reference advances a pointer j by 2 on each
    match against the raw (possibly duplicated) split array; duplicates can
    desync the pointer so later legitimate splits are missed. We transcribe
    that exact behavior — the mask is parity-critical (it selects which
    pixels receive fresh directions)."""
    row_of = np.zeros(n_kept, dtype=np.int64)
    A = [int(s) for s in split_positions]
    i, j, out = 0, 0, 0
    while i < n_kept:
        if j < len(A) and i == A[j]:
            row_of[i] = out
            if i + 1 < n_kept:
                row_of[i + 1] = out + 1
            out += 2
            j += 2
        else:
            row_of[i] = out
            if i + 1 < n_kept:
                row_of[i + 1] = out
            out += 1
        i += 2
    return row_of


def _axis_plan(in_size: int, out_size: int, split_plan_size: int):
    """Kept-line plan for one axis of random_nearest_downsample.

    in_size:  original latent extent (H or W)
    out_size: downsample_size extent (h or w)
    Returns (src_map, mask_line_of):
      src_map      (2*out_size,) original line index feeding kept line k
      mask_line_of (2*out_size,) original line the sampled-mask bit of kept
                   line k lands on (reference-exact restore semantics)
    """
    n_keep, block_sz = to_even_rational(out_size / in_size)
    n_remove = block_sz - n_keep
    num_blocks = (out_size * 2) // n_keep
    if num_blocks * block_sz > in_size * 2:
        num_blocks -= 1
    blocks_extent = num_blocks * block_sz

    offsets, masked_blocks = keep_blocks(block_sz, n_remove)
    kept = (np.arange(0, blocks_extent, block_sz)[:, None] + offsets).ravel()
    kept = kept[kept < in_size * 2]
    remain = out_size * 2 - len(kept)
    # Reference quirk preserved:
    # when the keep plan over/undershoots (get_keep_blocks interval overflow,
    # tail truncation at the array end), torch's forgiving slicing just
    # produces a DIFFERENT number of kept lines — the effective downsample
    # size shrinks or grows. 50 of the reachable (H, downsample) ratios hit
    # this; we reproduce it exactly via the effective length.
    tail = np.arange(blocks_extent,
                     min(blocks_extent + max(remain, 0), in_size * 2))
    kept = np.concatenate([kept, tail])
    if len(kept) % 2:
        raise ValueError(
            f"odd effective keep count for in={in_size} out={out_size}: the "
            f"reference algorithm itself fails on this shape")
    src_map = kept // 2  # compose with the nearest 2x upsample

    # reference-exact mask restore positions: splits recorded at
    # arange(0, out*2, n_keep) + masked_blocks (elastic_diffusion.py:591-593)
    # (computed from the REQUESTED out size even when the effective length
    # differs — the reference builds them the same way)
    if len(masked_blocks):
        split_positions = (np.arange(0, out_size * 2, n_keep)[:, None]
                           + masked_blocks).ravel()
    else:
        split_positions = np.asarray([], dtype=np.int64)
    mask_line_of = _restore_row_of(len(kept), split_positions)
    # lines whose restore position falls beyond the original extent are
    # dropped by the reference's shape-pad;
    # mark them to scatter into a discard slot
    mask_line_of = np.where(mask_line_of < in_size, mask_line_of, in_size)
    return src_map.astype(np.int32), mask_line_of.astype(np.int32)


@dataclass(frozen=True, eq=False)
class ResamplePlan(PlanTensors):
    """Static plan for one (latent HxW -> downsample hxw) resolution pair.

    out_h/out_w are the EFFECTIVE sizes (which can differ from the requested
    downsample size at awkward ratios — see the quirk note in _axis_plan);
    requested_* record what was asked for.
    """

    in_h: int
    in_w: int
    out_h: int
    out_w: int
    requested_h: int
    requested_w: int
    row_src: np.ndarray        # (2*out_h,) source latent row per kept line
    col_src: np.ndarray        # (2*out_w,)
    row_mask_of: np.ndarray    # (2*out_h,) restore row (in_h = discard slot)
    col_mask_of: np.ndarray    # (2*out_w,)

    @property
    def num_blocks(self) -> int:
        return self.out_h * self.out_w


def build_resample_plan(in_h: int, in_w: int, out_h: int, out_w: int) -> ResamplePlan:
    row_src, row_mask_of = _axis_plan(in_h, out_h, out_h * 2)
    col_src, col_mask_of = _axis_plan(in_w, out_w, out_w * 2)
    return ResamplePlan(in_h=in_h, in_w=in_w,
                        out_h=len(row_src) // 2, out_w=len(col_src) // 2,
                        requested_h=out_h, requested_w=out_w,
                        row_src=row_src, col_src=col_src,
                        row_mask_of=row_mask_of, col_mask_of=col_mask_of)


# ---------------------------------------------------------------------------
# Device ops
# ---------------------------------------------------------------------------


def sample_pick_indices(generator: torch.Generator,
                        exclude_mask: Optional[torch.Tensor],
                        num_blocks: int) -> torch.Tensor:
    """Uniform pick in [0,4) per block, avoiding excluded entries.

    The reference rejection-samples; a uniform-argmax over the allowed set is
    the same distribution with a static shape. When every entry of a row is
    excluded, fall back to a fresh uniform pick over all 4.
    """
    dev = generator.device
    if exclude_mask is None:
        return torch.randint(0, 4, (num_blocks,), generator=generator,
                             device=dev)
    u = torch.rand((num_blocks, 4), generator=generator, device=dev)
    pick = torch.where(exclude_mask, -1.0, u).argmax(dim=1)
    fallback = torch.randint(0, 4, (num_blocks,), generator=generator,
                             device=dev)
    return torch.where(exclude_mask.all(dim=1), fallback, pick)


def mix_with_prev(generator: torch.Generator, new_idx: torch.Tensor,
                  prev_idx: torch.Tensor, drop_p: float) -> torch.Tensor:
    """Keep the previous pick with probability drop_p (= 1 - new_p)."""
    keep_prev = torch.rand(new_idx.shape, generator=generator,
                           device=generator.device) < drop_p
    return torch.where(keep_prev, prev_idx, new_idx)


def apply_resample(latent: torch.Tensor, plan: ResamplePlan,
                   pick: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Randomized rational downsample as one gather.

    latent: (B, C, H, W); pick: (out_h*out_w,) integers in [0,4)
    Returns (downsampled (B,C,out_h,out_w), sampled_mask (H,W) bool).
    """
    dev = latent.device
    h, w = plan.out_h, plan.out_w
    r = pick.to(device=dev, dtype=torch.int64).reshape(h, w)
    roff, coff = r // 2, r % 2
    # kept-grid coordinates chosen per block
    ky = 2 * torch.arange(h, device=dev)[:, None] + roff      # (h, w)
    kx = 2 * torch.arange(w, device=dev)[None, :] + coff      # (h, w)
    rows = plan.on("row_src", dev)[ky]                        # original rows
    cols = plan.on("col_src", dev)[kx]                        # original cols
    down = latent[:, :, rows, cols]                           # (B, C, h, w)

    # sampled mask on the kept grid: kept[k, l] True iff block (k//2, l//2)
    # picked offset (k%2, l%2)
    kk = torch.arange(2 * h, device=dev)[:, None]
    ll = torch.arange(2 * w, device=dev)[None, :]
    kept_mask = ((roff[kk // 2, ll // 2] == kk % 2)
                 & (coff[kk // 2, ll // 2] == ll % 2))

    # scatter through the reference-exact restore maps: several kept lines
    # may land on one original line, and a pixel is sampled if any of them
    # was (a logical OR, written as an integer sum); the extra row and column
    # are the discard slot and are trimmed
    mrow = plan.on("row_mask_of", dev)[:, None].expand(2 * h, 2 * w)
    mcol = plan.on("col_mask_of", dev)[None, :].expand(2 * h, 2 * w)
    hits = torch.zeros((plan.in_h + 1, plan.in_w + 1), dtype=torch.int32,
                       device=dev)
    hits.index_put_((mrow, mcol), kept_mask.to(torch.int32), accumulate=True)
    return down, hits[:plan.in_h, :plan.in_w] > 0


def nearest_pick_indices(num_blocks: int, device) -> torch.Tensor:
    """The deterministic top-left pick of resampling step 0: (num_blocks,)
    int32 zeros on `device`."""
    return torch.zeros((num_blocks,), dtype=torch.int32, device=device)


def update_exclude_mask(exclude_mask: torch.Tensor,
                        pick: torch.Tensor) -> torch.Tensor:
    """Mark the chosen entry of each block as used (out of place)."""
    out = exclude_mask.clone()
    out[torch.arange(pick.shape[0], device=pick.device), pick] = True
    return out


def get_downsample_size(height: int, width: int, native_resolution: int,
                        vae_scale_factor: int = 8) -> Tuple[int, int]:
    """Latent-space downsample target:
    f = max(max(H,W)/native, 1);  (int((H // f) // vsf), int((W // f) // vsf))."""
    factor = max(max(height, width) / native_resolution, 1)
    return (int((height // factor) // vae_scale_factor),
            int((width // factor) // vae_scale_factor))


def compute_downsampling_size(h: int, w: int,
                              scale_factor: float) -> Tuple[int, int]:
    """(floor(h * scale_factor), floor(w * scale_factor))."""
    return (math.floor(h * scale_factor), math.floor(w * scale_factor))


def fill_in(target: torch.Tensor, filled: torch.Tensor, direction: torch.Tensor,
            mask_hw: torch.Tensor, fill_all: bool):
    """Scatter the upsampled low-res direction into the accumulator.

    An explicit (target, filled) pair takes the place of the reference's
    NaN-sentinel tensor:
      target <- where(mask, upsample(direction), target);  filled |= mask
      fill_all: remaining unfilled positions also take the upsampled value.
    A later call overwrites an earlier one where their masks overlap.
    """
    up = nearest_resize(direction, (target.shape[-2], target.shape[-1]))
    target = torch.where(mask_hw, up, target)
    filled = filled | mask_hw
    if fill_all:
        target = torch.where(filled, target, up)
        filled = torch.ones_like(filled)
    return target, filled
