"""CLIP BPE tokenizer, self-contained (no transformers runtime dependency).

Stable Diffusion tokenizes with transformers.CLIPTokenizer,
padding='max_length', max_length=77, truncation=True. This implements the
same byte-level BPE when a vocab directory (vocab.json + merges.txt, the
standard HF layout) is available, and falls back to a deterministic hash
tokenizer when running without a vocabulary: the fallback keeps every
pipeline shape-correct and deterministic, which is all the random-weights
paths need.
"""

from __future__ import annotations

import functools
import gzip
import hashlib
import html
import json
import os
import re
from typing import List, Optional

import numpy as np

try:  # the true CLIP pattern needs \p{L}/\p{N} (regex module, a
    import regex as _regex  # transformers dependency, present wherever it is)
except ImportError:  # pragma: no cover
    _regex = None


def _basic_clean(text: str) -> str:
    text = html.unescape(html.unescape(text))
    return text.strip()


def _whitespace_clean(text: str) -> str:
    return re.sub(r"\s+", " ", text).strip()


@functools.lru_cache()
def _bytes_to_unicode():
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(2 ** 8):
        if b not in bs:
            bs.append(b)
            cs.append(2 ** 8 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _get_pairs(word):
    pairs = set()
    prev = word[0]
    for ch in word[1:]:
        pairs.add((prev, ch))
        prev = ch
    return pairs


class CLIPTokenizer:
    """Byte-level BPE with the CLIP text cleaning/regex conventions."""

    # the genuine CLIP pattern (transformers tokenization_clip.py) when the
    # regex module is available; ASCII approximation otherwise
    if _regex is not None:
        PAT = _regex.compile(
            r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|"""
            r"""[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+""", _regex.IGNORECASE)
    else:  # pragma: no cover
        PAT = re.compile(
            r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|"""
            r"""[a-zA-Z]+|[0-9]|[^\sa-zA-Z0-9]+""", re.IGNORECASE)

    def __init__(self, vocab_dir: Optional[str] = None,
                 model_max_length: int = 77,
                 bos_token_id: Optional[int] = None,
                 eos_token_id: Optional[int] = None,
                 pad_token_id: Optional[int] = None,
                 vocab_size: int = 49408):
        self.model_max_length = model_max_length
        self._explicit_ids = (bos_token_id, eos_token_id, pad_token_id)
        # CLIP convention: BOS/EOS are the last two vocab entries
        self.bos_token_id = vocab_size - 2 if bos_token_id is None else bos_token_id
        self.eos_token_id = vocab_size - 1 if eos_token_id is None else eos_token_id
        eos_token_id = self.eos_token_id
        # SD1.x/2.x pad with EOS; SDXL tokenizer_2 pads with id 0
        self.pad_token_id = eos_token_id if pad_token_id is None else pad_token_id
        self.vocab_size = vocab_size
        self.byte_encoder = _bytes_to_unicode()
        self.encoder = None
        self.bpe_ranks = None
        self.cache = {"<|startoftext|>": "<|startoftext|>",
                      "<|endoftext|>": "<|endoftext|>"}
        if vocab_dir is not None:
            self._load_vocab(vocab_dir)

    def _load_vocab(self, vocab_dir: str):
        vocab_path = os.path.join(vocab_dir, "vocab.json")
        merges_path = os.path.join(vocab_dir, "merges.txt")
        with open(vocab_path) as f:
            self.encoder = json.load(f)
        opener = gzip.open if merges_path.endswith(".gz") else open
        with opener(merges_path, "rt") as f:
            merges = f.read().split("\n")
        if merges and merges[0].startswith("#"):
            merges = merges[1:]
        merges = [tuple(m.split()) for m in merges if m and len(m.split()) == 2]
        self.bpe_ranks = dict(zip(merges, range(len(merges))))
        self.vocab_size = len(self.encoder)
        # rebind special ids from the actual vocab (defaults assumed the
        # standard 49408-entry CLIP vocab); explicit ctor args still win
        bos, eos, pad = self._explicit_ids
        self.bos_token_id = self.encoder.get(
            "<|startoftext|>", self.vocab_size - 2) if bos is None else bos
        self.eos_token_id = self.encoder.get(
            "<|endoftext|>", self.vocab_size - 1) if eos is None else eos
        self.pad_token_id = self.eos_token_id if pad is None else pad

    @property
    def has_vocab(self) -> bool:
        return self.encoder is not None

    def _bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if word[i] == first and i < len(word) - 1 and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def _encode_text(self, text: str) -> List[int]:
        text = _whitespace_clean(_basic_clean(text)).lower()
        ids: List[int] = []
        for token in self.PAT.findall(text):
            if self.has_vocab:
                token_b = "".join(self.byte_encoder[b]
                                  for b in token.encode("utf-8"))
                for bpe_token in self._bpe(token_b).split(" "):
                    ids.append(self.encoder.get(
                        bpe_token, self.encoder.get("<|endoftext|>",
                                                    self.eos_token_id)))
            else:
                # deterministic fallback: stable hash into the vocab interior
                h = int(hashlib.md5(token.encode()).hexdigest()[:8], 16)
                ids.append(1 + h % (self.vocab_size - 3))
        return ids

    def __call__(self, prompts, padding: str = "max_length",
                 truncation: bool = True) -> np.ndarray:
        """List[str] | str -> (B, model_max_length) int32, BOS ... EOS PAD*."""
        if isinstance(prompts, str):
            prompts = [prompts]
        L = self.model_max_length
        out = np.full((len(prompts), L), self.pad_token_id, dtype=np.int32)
        for i, p in enumerate(prompts):
            ids = self._encode_text(p)[:L - 2]
            row = [self.bos_token_id] + ids + [self.eos_token_id]
            out[i, :len(row)] = row
        return out
