"""The one traffic generator: requests of a traffic mix file, drawn from
the run's seed. A request is a prompt of a number of words drawn from the
mix's word list, the mix's negative prompt, and the image's own seed; its
size and sampler settings are the mix's. Every seed gives the same work
(the text encoders always read 77 tokens), only other words and noise.

A mix with a ``condition`` block gives each request a ControlNet condition
image, drawn from the image's seed (``condition_image``), taken at the
mix's ``controlnet_conditioning_scale``."""

from __future__ import annotations

from typing import Dict, Iterator, Optional

import numpy as np
import torch

from .cells import HERE


def requests(traffic: dict, seed: int, stream: int = 0) -> Iterator[Dict]:
    """An endless sequence of requests from `seed`; `stream` 1 is the
    warm-up's, 0 the measured window's."""
    words = (HERE / "traffic" / traffic["words"]).read_text().split()
    lo, hi = traffic["prompt_words"]
    rng = np.random.default_rng([int(seed) % 2 ** 64, stream])
    while True:
        n = int(rng.integers(lo, hi + 1))
        yield {"prompt": " ".join(rng.choice(words, n)),
               "negative": traffic["negative_prompt"],
               "seed": int(rng.integers(0, 2 ** 31))}


def condition_image(traffic: dict, image_seed: int, device) -> Optional[torch.Tensor]:
    """The ControlNet condition of a request, (1, 3, H, W) float32 in
    {0, 1} at the image's size, or None for a mix without a ``condition``
    block. ``{"kind": "edges", "shapes": [lo, hi], "line_px": w}``: the
    outlines, `w` pixels wide, of lo .. hi circles and axis-aligned
    rectangles of random centres and sizes, white on black and the same in
    the three channels, as a canny edge map is given to a ControlNet. The
    shapes are drawn from the image's seed; the rasterising runs on
    `device`, the same for the program and the reference."""
    spec = traffic.get("condition")
    if spec is None:
        return None
    if spec["kind"] != "edges":
        raise ValueError(f"unknown condition kind {spec['kind']!r}")
    H, W = int(traffic["height"]), int(traffic["width"])
    rng = np.random.default_rng([int(image_seed) % 2 ** 64, 13])
    lo, hi = spec["shapes"]
    half = float(spec["line_px"]) / 2
    yy = torch.arange(H, device=device, dtype=torch.float32)[:, None]
    xx = torch.arange(W, device=device, dtype=torch.float32)[None, :]
    edges = torch.zeros((H, W), dtype=torch.bool, device=device)
    for _ in range(int(rng.integers(lo, hi + 1))):
        cy, cx = rng.uniform(0, H), rng.uniform(0, W)
        a, b = rng.uniform(0.04, 0.3, 2) * min(H, W)
        dy, dx = (yy - cy).abs(), (xx - cx).abs()
        if rng.integers(2):
            edges |= (torch.sqrt(dy * dy + dx * dx) - a).abs() < half
        else:
            outer = (dy <= a + half) & (dx <= b + half)
            inner = (dy < a - half) & (dx < b - half)
            edges |= outer & ~inner
    return edges.to(torch.float32).expand(1, 3, H, W).contiguous()
