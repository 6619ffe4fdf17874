"""Image assembly helpers: PIL conversion, grids."""

from __future__ import annotations

import numpy as np


def to_pil(img_nchw) -> list:
    """(B, 3, H, W) in [0,1] (numpy array or tensor) -> list of PIL images.

    A tensor is clipped, scaled, rounded and cast to uint8 where it lives,
    so a GPU image crosses to the host as uint8."""
    from PIL import Image
    import torch
    if isinstance(img_nchw, torch.Tensor):
        u8 = (img_nchw.float().clamp(0.0, 1.0) * 255.0).round().to(torch.uint8)
        arr = u8.permute(0, 2, 3, 1).cpu().numpy()
    else:
        arr = np.clip(np.asarray(img_nchw, dtype=np.float32), 0.0, 1.0)
        arr *= 255.0
        np.rint(arr, out=arr)
        arr = arr.astype(np.uint8).transpose(0, 2, 3, 1)
    return [Image.fromarray(np.ascontiguousarray(a)) for a in arr]


def make_grid(imgs_nchw, nrow: int = 8, padding: int = 2) -> np.ndarray:
    """torchvision.utils.make_grid semantics (row-major, padded borders).
    imgs: (B, C, H, W) in [0,1] -> (C, gh, gw)."""
    imgs = np.asarray(imgs_nchw, dtype=np.float32)
    B, C, H, W = imgs.shape
    ncol = min(nrow, B)
    nrows = int(np.ceil(B / ncol))
    gh = nrows * (H + padding) + padding
    gw = ncol * (W + padding) + padding
    grid = np.zeros((C, gh, gw), dtype=np.float32)
    for idx in range(B):
        r, c = divmod(idx, ncol)
        y = padding + r * (H + padding)
        x = padding + c * (W + padding)
        grid[:, y:y + H, x:x + W] = imgs[idx]
    return grid
