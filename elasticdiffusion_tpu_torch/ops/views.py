"""Patch-view geometry: static host-side plans for the local signal.

All index math happens once on the host in numpy (the view boxes, the context
crop with its border rebalancing, the collapsed-dim edge case, the
first-writer-wins owner map). All views have identical static shapes, so the
whole local pass is ONE batched gather, ONE batched UNet call and ONE gather
writeback through the owner map: deterministic by construction, no atomics.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Tuple

import numpy as np
import torch

from ..configs import ViewConfig


class PlanTensors:
    """Mixin of the static plans: their numpy index arrays as int64 tensors
    on a device, uploaded once per plan and device and kept on the plan."""

    def on(self, name: str, device) -> torch.Tensor:
        cache = self.__dict__.setdefault("_tensors", {})
        key = (name, str(device))
        if key not in cache:
            arr = np.asarray(getattr(self, name)).astype(np.int64)
            cache[key] = torch.from_numpy(arr).to(device)
        return cache[key]


def get_views(panorama_height: int, panorama_width: int, h_ws: int = 64,
              w_ws: int = 64, stride: int = 32, vae_scale_factor: int = 8,
              **_ignored) -> List[Tuple[int, int, int, int]]:
    """View boxes of a panorama given in pixels: latent-space
    (h_start, h_end, w_start, w_end) tuples of ``get_views_latent`` over
    the (height / vae_scale_factor, width / vae_scale_factor) latent grid.
    Raises ValueError when a size does not divide by the scale factor."""
    if panorama_height % vae_scale_factor or panorama_width % vae_scale_factor:
        raise ValueError(
            f"height {panorama_height} and width {panorama_width} must be "
            f"divisible by {vae_scale_factor}")
    return get_views_latent(panorama_height // vae_scale_factor,
                            panorama_width // vae_scale_factor,
                            h_ws=h_ws, w_ws=w_ws, stride=stride)


def get_views_latent(H: int, W: int, h_ws: int, w_ws: int,
                     stride: int) -> List[Tuple[int, int, int, int]]:
    """View boxes over the latent grid: (h_start, h_end, w_start, w_end)
    tuples in latent units, with last-row/col snap-back."""
    nbh = math.ceil((H - h_ws) / stride) + 1 if stride else 1
    nbw = math.ceil((W - w_ws) / stride) + 1 if stride else 1
    views = []
    for i in range(int(nbh * nbw)):
        h_start = int((i // nbw) * stride)
        h_end = h_start + h_ws
        if h_end > H:  # snap back the last row
            h_start = max(0, h_start - (h_end - H))
            h_end = H
        w_start = int((i % nbw) * stride)
        w_end = w_start + w_ws
        if w_end > W:
            w_start = max(0, w_start - (w_end - W))
            w_end = W
        views.append((h_start, h_end, w_start, w_end))
    return views


def _context_lines(start: int, end: int, limit: int, S: int, n: int):
    """Strided context line indices on both sides of [start, end), with the
    reference's border rebalancing:
    when one side is short, the other side gets up to 2n total.

    Returns (before_idx, after_idx) numpy arrays.
    """
    if start - n * S < 0:
        before = np.arange(max(0, start - n * S), start - S + 1, S)
        n_after = 2 * n - len(before)
        after = np.arange(end - 1 + S, min(limit, end + n_after * S), S)
    else:
        after = np.arange(end - 1 + S, min(limit, end + n * S), S)
        n_before = 2 * n - len(after)
        before = np.arange(max(0, start - n_before * S), start - S + 1, S)
    return before, after


def crop_with_context_indices(H: int, W: int, a: int, b: int, c: int, d: int,
                              S: int, n: int):
    """Index vectors for one context crop.

    Returns (rows, cols, (n_t, n_b, n_l, n_r)): gathering X[rows][:, cols]
    gives the context crop, whose layout is
    [top ctx | a:b | bottom ctx] x [left ctx | c:d | right ctx].
    """
    top, bottom = _context_lines(a, b, H, S, n)
    left, right = _context_lines(c, d, W, S, n)
    rows = np.concatenate([top, np.arange(a, b), bottom]).astype(np.int64)
    cols = np.concatenate([left, np.arange(c, d), right]).astype(np.int64)
    return rows, cols, (len(top), len(bottom), len(left), len(right))


@dataclass(frozen=True, eq=False)
class ViewPlan(PlanTensors):
    """Static plan for the local-uncond pass at one latent resolution."""

    latent_h: int
    latent_w: int
    views: Tuple[Tuple[int, int, int, int], ...]
    # stacked context-crop gathers: latent[:, :, rows[v][:,None], cols[v][None,:]]
    rows: np.ndarray          # (V, out_h) int32
    cols: np.ndarray          # (V, out_w) int32
    margins: np.ndarray       # (V, 4) int32: n_t, n_b, n_l, n_r
    # first-writer-wins writeback gather: out[y,x] = preds[ov, :, oy, ox]
    owner_view: np.ndarray    # (H, W) int32
    owner_y: np.ndarray       # (H, W) int32 (row inside the view output)
    owner_x: np.ndarray       # (H, W) int32

    @property
    def num_views(self) -> int:
        return len(self.views)

    @property
    def out_shape(self) -> Tuple[int, int]:
        return (self.rows.shape[1], self.cols.shape[1])


def build_view_plan(latent_h: int, latent_w: int, view_config: ViewConfig) -> ViewPlan:
    """Build the complete static plan for compute_local_uncond_signal.

    Collapsed-dim edge case:
    when window + context >= latent extent in a dimension, the window covers
    the whole extent and no context lines are used in that dimension.
    """
    ctx = view_config.context_size
    h_ws = latent_h if view_config.window_size + ctx >= latent_h else view_config.window_size
    w_ws = latent_w if view_config.window_size + ctx >= latent_w else view_config.window_size

    views = get_views_latent(latent_h, latent_w, h_ws=h_ws, w_ws=w_ws,
                             stride=view_config.stride)
    n = ctx // 2
    rows_l, cols_l, margins_l = [], [], []
    for (a, b, c, d) in views:
        rows, cols, m = crop_with_context_indices(latent_h, latent_w, a, b, c, d,
                                                  S=1, n=n)
        rows_l.append(rows)
        cols_l.append(cols)
        margins_l.append(m)
    out_hs = {len(r) for r in rows_l}
    out_ws = {len(c) for c in cols_l}
    if len(out_hs) != 1 or len(out_ws) != 1:
        raise ValueError(f"views produced ragged context crops: "
                         f"{out_hs}x{out_ws}")
    rows = np.stack(rows_l).astype(np.int32)
    cols = np.stack(cols_l).astype(np.int32)
    margins = np.asarray(margins_l, dtype=np.int32)

    # first-writer-wins: owner = lowest view index covering each pixel
    owner_view = np.full((latent_h, latent_w), -1, dtype=np.int32)
    owner_y = np.zeros((latent_h, latent_w), dtype=np.int32)
    owner_x = np.zeros((latent_h, latent_w), dtype=np.int32)
    for v, (a, b, c, d) in enumerate(views):
        n_t, n_b, n_l, n_r = margins[v]
        region = owner_view[a:b, c:d]
        fresh = region == -1
        yy, xx = np.nonzero(fresh)
        owner_view[a:b, c:d][yy, xx] = v
        owner_y[a:b, c:d][yy, xx] = n_t + yy
        owner_x[a:b, c:d][yy, xx] = n_l + xx
    if (owner_view < 0).any():
        raise ValueError("views do not tile the latent grid")

    return ViewPlan(latent_h=latent_h, latent_w=latent_w, views=tuple(views),
                    rows=rows, cols=cols, margins=margins,
                    owner_view=owner_view, owner_y=owner_y, owner_x=owner_x)


def gather_views(latent: torch.Tensor, plan: ViewPlan) -> torch.Tensor:
    """(B, C, H, W) -> (V, B, C, out_h, out_w) batched context crops, one
    gather for all views."""
    rows = plan.on("rows", latent.device)          # (V, out_h)
    cols = plan.on("cols", latent.device)          # (V, out_w)
    # out[v, b, c, i, j] = latent[b, c, rows[v, i], cols[v, j]]
    out = latent[:, :, rows[:, :, None], cols[:, None, :]]  # (B, C, V, oh, ow)
    return out.permute(2, 0, 1, 3, 4)


def scatter_first_writer(preds: torch.Tensor, plan: ViewPlan) -> torch.Tensor:
    """(V, B, C, out_h, out_w) -> (B, C, H, W) via the owner-map gather: the
    lowest view index that covers a pixel owns it (first writer wins)."""
    ov = plan.on("owner_view", preds.device)
    oy = plan.on("owner_y", preds.device)
    ox = plan.on("owner_x", preds.device)
    out = preds[ov, :, :, oy, ox]          # (H, W, B, C)
    return out.permute(2, 3, 0, 1)
