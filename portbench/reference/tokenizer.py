"""The CLIP tokenizer as Stable Diffusion runs it without a vocabulary file:
77 ids, BOS, the words, EOS, then padding (EOS, or 0 for SDXL's second
tokenizer). With no vocabulary (none exists offline), each word is a stable
md5 hash into the interior of the vocabulary.

A frozen copy of the program's fallback (``utils/tokenizer.py``): the
benchmark's prompts are lower-case ASCII words, commas and spaces, on which
the CLIP pattern and its ASCII approximation split alike.
"""

from __future__ import annotations

import hashlib
import html
import re
from typing import List, Sequence

import numpy as np

PATTERN = re.compile(
    r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|"""
    r"""[a-zA-Z]+|[0-9]|[^\sa-zA-Z0-9]+""", re.IGNORECASE)


def _clean(text: str) -> str:
    text = html.unescape(html.unescape(text)).strip()
    return re.sub(r"\s+", " ", text).strip().lower()


def word_ids(text: str, vocab_size: int) -> List[int]:
    return [1 + int(hashlib.md5(tok.encode()).hexdigest()[:8], 16) % (vocab_size - 3)
            for tok in PATTERN.findall(_clean(text))]


def tokenize(prompts: Sequence[str], vocab_size: int, pad_id: int = None,
             length: int = 77) -> np.ndarray:
    """(len(prompts), length) int64 ids; BOS = vocab_size - 2, EOS =
    vocab_size - 1, padding with `pad_id` (EOS when None)."""
    bos, eos = vocab_size - 2, vocab_size - 1
    out = np.full((len(prompts), length), eos if pad_id is None else pad_id,
                  dtype=np.int64)
    for i, p in enumerate(prompts):
        row = [bos] + word_ids(p, vocab_size)[:length - 2] + [eos]
        out[i, :len(row)] = row
    return out
