"""Condition preprocessors of the ControlNet path: canny and depth.

Counterpart of ``elasticdiffusion_tpu/apps/preprocessors.py``, with its own
copy of the numpy code (the port imports nothing of the JAX package):

  canny  cv2.Canny(img, 100, 200)'s algorithm in numpy -> 3-channel image
  depth  the port's DPT (``models/dpt.py``) -> 3-channel image

``prepare_image`` turns the condition into the (B, 3, H, W) array in [0, 1]
that ``ElasticDiffusion.generate_image(condition_image=...)`` takes.
"""

from __future__ import annotations

import os
import warnings
from typing import Callable, Optional

import numpy as np

_builtin_depth_fn: Optional[Callable] = None


def default_depth_fn() -> Callable:
    """The depth estimator ``process_condition_image`` uses when no
    depth_fn is given: the port's DPT-large, built once, on the GPU.

    ``ED_DPT_DIR`` (a converted Intel/dpt-large checkpoint) raises: loading
    checkpoints is not ported yet. ``ED_DPT_ALLOW_RANDOM=1`` opts into
    random weights (the depth maps are structured noise). Without either it
    raises, so that a missing checkpoint never passes silently."""
    global _builtin_depth_fn
    if _builtin_depth_fn is None:
        if os.environ.get("ED_DPT_DIR"):
            raise NotImplementedError(
                "ED_DPT_DIR: loading DPT checkpoints waits until checkpoint "
                "files are part of the repository (ROADMAP.md Queue 1, "
                "'real checkpoints')")
        if os.environ.get("ED_DPT_ALLOW_RANDOM") != "1":
            raise RuntimeError(
                "depth ControlNet needs DPT weights: set ED_DPT_DIR to a "
                "converted Intel/dpt-large checkpoint directory, or set "
                "ED_DPT_ALLOW_RANDOM=1 to opt into random weights")
        warnings.warn("ED_DPT_ALLOW_RANDOM=1: a random-init depth estimator; "
                      "its depth maps are structured noise")
        from ..models.dpt import DPT_LARGE, make_depth_fn, random_dpt
        _builtin_depth_fn = make_depth_fn(random_dpt(DPT_LARGE))
    return _builtin_depth_fn


def _sobel3(img2d: np.ndarray):
    """3x3 Sobel with replicate border (cv2.Canny's Sobel call)."""
    p = np.pad(img2d, 1, mode="edge")
    gx = (p[:-2, 2:] + 2 * p[1:-1, 2:] + p[2:, 2:]
          - p[:-2, :-2] - 2 * p[1:-1, :-2] - p[2:, :-2])
    gy = (p[2:, :-2] + 2 * p[2:, 1:-1] + p[2:, 2:]
          - p[:-2, :-2] - 2 * p[:-2, 1:-1] - p[:-2, 2:])
    return gx, gy


def canny(image: np.ndarray, low: float = 100.0,
          high: float = 200.0) -> np.ndarray:
    """cv2.Canny's edges (apertureSize=3, L2gradient=False). image: (H, W)
    or (H, W, C) uint8/float. Returns the (H, W) uint8 edge map {0, 255}.

    As OpenCV's canny.cpp:
      - Sobel 3x3 with replicate border; L1 magnitude |gx| + |gy|
      - multi-channel input: per pixel, the channel with the largest
        magnitude supplies (gx, gy); no conversion to gray
      - non-maximum suppression in four sectors split at tan 22.5 and
        tan 67.5, with cv2's tie-breaks: horizontal 'm > left && m >=
        right', vertical 'm > up && m >= down', diagonals strict both sides
      - the magnitude map zero-padded at the border
      - strict double threshold (strong m > high, candidate m > low);
        8-connected hysteresis from the strong pixels"""
    img = np.asarray(image, dtype=np.float32)
    if img.ndim == 3:
        # per-pixel max-magnitude channel (strict >: ties keep the lowest)
        gxc = np.empty(img.shape, np.float32)
        gyc = np.empty(img.shape, np.float32)
        for c in range(img.shape[-1]):
            gxc[..., c], gyc[..., c] = _sobel3(img[..., c])
        magc = np.abs(gxc) + np.abs(gyc)
        pick = np.argmax(magc, axis=-1)
        gx = np.take_along_axis(gxc, pick[..., None], axis=-1)[..., 0]
        gy = np.take_along_axis(gyc, pick[..., None], axis=-1)[..., 0]
    else:
        gx, gy = _sobel3(img)
    H, W = gx.shape
    mag = np.abs(gx) + np.abs(gy)

    mp = np.pad(mag, 1)  # zero border, as cv2's map
    left, right = mp[1:-1, :-2], mp[1:-1, 2:]
    up, down = mp[:-2, 1:-1], mp[2:, 1:-1]
    ul, ur = mp[:-2, :-2], mp[:-2, 2:]
    dl, dr = mp[2:, :-2], mp[2:, 2:]
    ax, ay = np.abs(gx), np.abs(gy)
    TG22 = 0.4142135623730951           # tan(22.5 deg)
    horiz = ay < ax * TG22
    vert = ay > ax * (TG22 + 2.0)       # tan(67.5) = tan(22.5) + 2
    same_sign = (gx * gy) >= 0
    keep = np.where(
        horiz, (mag > left) & (mag >= right),
        np.where(vert, (mag > up) & (mag >= down),
                 np.where(same_sign, (mag > ul) & (mag > dr),
                          (mag > ur) & (mag > dl))))

    strong = keep & (mag > high)
    weak = keep & (mag > low) & ~strong

    edges = strong.copy()
    stack = list(zip(*np.nonzero(strong)))
    offs = [(-1, -1), (-1, 0), (-1, 1), (0, -1), (0, 1), (1, -1), (1, 0),
            (1, 1)]
    while stack:
        y, x = stack.pop()
        for dy, dx in offs:
            ny, nx = y + dy, x + dx
            if 0 <= ny < H and 0 <= nx < W and weak[ny, nx] \
                    and not edges[ny, nx]:
                edges[ny, nx] = True
                stack.append((ny, nx))
    return (edges * 255).astype(np.uint8)


def process_condition_image(condition_image, controlnet_model: str,
                            depth_fn: Optional[Callable] = None):
    """condition_image: a PIL image or an (H, W, 3) array. Returns the PIL
    3-channel condition image of `controlnet_model` ('canny' | 'depth')."""
    from PIL import Image
    arr = np.asarray(condition_image)
    if controlnet_model == "canny":
        e = canny(arr, 100, 200)
        return Image.fromarray(np.stack([e, e, e], axis=-1))
    if controlnet_model == "depth":
        if depth_fn is None:
            depth_fn = default_depth_fn()
        d = np.asarray(depth_fn(condition_image), dtype=np.float32)
        d = (255 * (d - d.min()) / max(d.max() - d.min(), 1e-8)).astype(np.uint8)
        return Image.fromarray(np.stack([d, d, d], axis=-1))
    raise ValueError(f"unknown controlnet_model {controlnet_model}")


def prepare_image(image, width: int, height: int, batch_size: int = 1,
                  do_classifier_free_guidance: bool = False) -> np.ndarray:
    """diffusers' VaeImageProcessor(do_normalize=False): resize to (height,
    width) with Lanczos, scale to [0, 1], NCHW, repeated for the batch and
    the CFG pair."""
    from PIL import Image
    if not isinstance(image, Image.Image):
        image = Image.fromarray(np.asarray(image))
    image = image.convert("RGB").resize((width, height), Image.LANCZOS)
    arr = np.asarray(image, dtype=np.float32) / 255.0
    arr = arr.transpose(2, 0, 1)[None]
    arr = np.repeat(arr, batch_size, axis=0)
    if do_classifier_free_guidance:
        arr = np.concatenate([arr, arr])
    return arr
