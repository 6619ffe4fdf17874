"""The one traffic generator: requests of a traffic mix file, drawn from
the run's seed. A request is a prompt of a number of words drawn from the
mix's word list, the mix's negative prompt, and the image's own seed; its
size and sampler settings are the mix's. Every seed gives the same work
(the text encoders always read 77 tokens), only other words and noise."""

from __future__ import annotations

from typing import Dict, Iterator

import numpy as np

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
