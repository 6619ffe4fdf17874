"""Attention dispatch: the CUDA kernel on the GPU, plain torch ops elsewhere.

Layout ``(B, S, H, D)``: batch, sequence, heads, head dim.

The gate is the part of the JAX package's gate that is about the function:
non-causal, ``Sq >= 256``, ``D % 8 == 0``. Inside it a CUDA tensor launches
the kernel or raises. Below it (CLIP's causal attention, the UNet's 8x8 mid
block, the VAE encoder on thin background strips) plain ops run, as the JAX
package runs plain XLA ops there.
"""

from __future__ import annotations

import torch

from . import wants_kernel
from .flash_attention import flash_attention, reference_attention

FLASH_MIN_SEQ = 256

__all__ = ["FLASH_MIN_SEQ", "dot_product_attention", "flash_attention",
           "in_gate", "reference_attention"]


def in_gate(q: torch.Tensor, causal: bool) -> bool:
    return (not causal) and q.shape[1] >= FLASH_MIN_SEQ and q.shape[-1] % 8 == 0


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = False,
                          use_kernels: str = "auto") -> torch.Tensor:
    """(B, Sq, H, D) x (B, Sk, H, D) -> (B, Sq, H, D)."""
    if in_gate(q, causal):
        if wants_kernel(use_kernels, q.is_cuda, "dot_product_attention"):
            return flash_attention(q, k, v)
        if q.is_cuda:
            dot_product_attention.plain_cuda_calls += 1
    return reference_attention(q, k, v, causal=causal)


# times the plain version stood in for the kernel on a CUDA tensor
# (use_kernels='off' only)
dot_product_attention.plain_cuda_calls = 0
