"""Attention kernel wrapper: ``flash_attention`` and ``reference_attention``.

Replaces the Pallas TPU kernels of
``elasticdiffusion_tpu/kernels/flash_attention.py`` (``_oneshot_attention``,
``_flash_kernel_bf16_nn``, ``_flash_kernel``) with one CUDA C++ kernel,
``csrc/flash_attention.cu``: an online-softmax loop over key tiles, tensor
cores (``mma.sync``) for bf16 and full-precision FMAs for fp32, instantiated
for head dims 64 (the SD 2.x / SDXL UNet) and 512 (the VAE mid block).

Bound on this card: operations, ``4*B*H*Sq*Sk*D``, against the bf16 tensor
core peak (fp32: the CUDA-core peak); for cross-attention (Sk = 77) the q and
output bytes. See the source for what the design does about it.

Layout ``(B, S, H, D)``. Strided views are taken as they are when the last
dim is contiguous and the other strides keep 16-byte alignment.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import build, note_launch

HEAD_DIMS = (64, 512)
_LOG2E = 1.4426950408889634
_DTYPES = {torch.bfloat16: 0, torch.float32: 1}


def reference_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = False) -> torch.Tensor:
    """Plain attention that defines the numbers: logits and softmax in fp32,
    probabilities cast to ``v.dtype`` before the second product."""
    Sq, Sk, D = q.shape[1], k.shape[1], q.shape[-1]
    scale = 1.0 / math.sqrt(D)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        mask = torch.ones(Sq, Sk, dtype=torch.bool, device=q.device).tril(Sk - Sq)
        logits = logits.masked_fill(~mask, torch.finfo(torch.float32).min)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)


def _strided_ok(t: torch.Tensor) -> bool:
    align = 16 // t.element_size()
    return (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all(s % align == 0 for s in t.stride()[:-1]))


def flash_attention(q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """(B, Sq, H, D) x (B, Sk, H, D) -> (B, Sq, H, D), non-causal, on the GPU."""
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise RuntimeError("flash_attention launches a CUDA kernel and needs "
                           "CUDA tensors")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes bf16 or fp32 q/k/v of one type, "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    if k.shape != (B, Sk, H, D) or v.shape != (B, Sk, H, D):
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if Sk < 1 or Sq < 1:
        raise ValueError("empty sequence")
    unsupported = (f"flash_attention has no kernel for head dim {D} "
                   f"(built: {HEAD_DIMS}); SD 1.x head dims 40/80/160 are "
                   f"ROADMAP.md Queue 1 item 2")
    if D not in HEAD_DIMS:
        raise NotImplementedError(unsupported)
    q, k, v = (t if _strided_ok(t) else t.contiguous() for t in (q, k, v))
    out = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
    lib = build.load("flash_attention")
    fn = lib.ed_flash_attention
    if not fn.argtypes:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                       + [ctypes.c_longlong] * 9
                       + [ctypes.c_int, ctypes.c_float, ctypes.c_void_p])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  B, Sq, Sk, H, D,
                  q.stride(0), q.stride(1), q.stride(2),
                  k.stride(0), k.stride(1), k.stride(2),
                  v.stride(0), v.stride(1), v.stride(2),
                  _DTYPES[q.dtype], _LOG2E / math.sqrt(D), stream)
    build.check(lib, code, "flash_attention", unsupported)
    flash_attention.launches += 1
    note_launch("flash_attention", str(q.dtype), B, Sq, Sk, H, D)
    return out


flash_attention.launches = 0
