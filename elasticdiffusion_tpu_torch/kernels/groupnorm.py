"""GroupNorm(+SiLU) kernel wrapper: ``fused_group_norm`` and
``reference_group_norm``.

Replaces the Pallas TPU kernels ``fused_group_norm`` / ``_stats_kernel`` /
``_apply_kernel`` of ``elasticdiffusion_tpu/kernels/groupnorm.py`` with
``csrc/groupnorm.cu``: partial per-channel sums over row chunks, a small
finalize launch for the group moments, and an elementwise apply with
optional SiLU. No atomics, so results repeat from run to run.

Bound on this card: bytes (the activation read once and written once); the
kernel reads it twice, see the source.

Input ``(B, H, W, C)``, the NHWC view that a ``channels_last`` NCHW tensor
gives for free. fp32 statistics with ``var = E[x^2] - E[x]^2``, output in the
input dtype.
"""

from __future__ import annotations

import ctypes

import torch

from . import build, note_launch, wants_kernel
from .layernorm import _DTYPES, _param_flag

_TARGET_BLOCKS = 1024  # stats blocks to aim for: a few waves of 132 SMs


def reference_group_norm(x: torch.Tensor, weight: torch.Tensor,
                         bias: torch.Tensor, groups: int, eps: float = 1e-5,
                         silu: bool = False) -> torch.Tensor:
    """Plain NHWC GroupNorm, on the JAX package's formula."""
    shape = x.shape
    B, C = shape[0], shape[-1]
    xg = x.float().reshape(B, -1, groups, C // groups)
    mean = xg.mean(dim=(1, 3), keepdim=True)
    var = (xg * xg).mean(dim=(1, 3), keepdim=True) - mean * mean
    out = (xg - mean) * torch.rsqrt(var + eps)
    out = out.reshape(shape) * weight.float() + bias.float()
    if silu:
        out = out * torch.sigmoid(out)
    return out.to(x.dtype)


def fused_group_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                     groups: int, eps: float = 1e-5,
                     silu: bool = False) -> torch.Tensor:
    """x: (B, H, W, C) bf16 or fp32 on the GPU; returns ``x.dtype``."""
    if not (x.is_cuda and weight.is_cuda and bias.is_cuda):
        raise RuntimeError("fused_group_norm launches a CUDA kernel and needs "
                           "CUDA tensors")
    if x.dtype not in _DTYPES:
        raise TypeError(f"fused_group_norm takes bf16 or fp32, got {x.dtype}")
    if x.dim() != 4:
        raise ValueError(f"fused_group_norm takes (B, H, W, C), got "
                         f"{tuple(x.shape)}")
    B, H, W, C = x.shape
    if C % groups:
        raise ValueError(f"{C} channels do not split into {groups} groups")
    w_bf16 = _param_flag(weight, bias, C)
    x = x.contiguous()
    S = H * W
    y = torch.empty_like(x)
    vec = 16 // x.element_size()
    vectorized = int(C % vec == 0 and x.data_ptr() % 16 == 0
                     and y.data_ptr() % 16 == 0)
    cv = C // vec if vectorized else C
    tx = min(cv, 256)
    ty = 256 // tx
    zc = -(-cv // tx)
    nchunks = max(1, min(_TARGET_BLOCKS // (B * zc), -(-S // (4 * ty))))
    partial = torch.empty((B, nchunks, 2, C), dtype=torch.float32,
                          device=x.device)
    scale_shift = torch.empty((2, B, C), dtype=torch.float32, device=x.device)
    lib = build.load("groupnorm")
    fn = lib.ed_group_norm
    if not fn.argtypes:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int]
                       + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                       + [ctypes.c_float] + [ctypes.c_int] * 3
                       + [ctypes.c_void_p])
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = fn(x.data_ptr(), weight.data_ptr(), bias.data_ptr(), w_bf16,
                  y.data_ptr(), partial.data_ptr(), scale_shift[0].data_ptr(),
                  scale_shift[1].data_ptr(), B, S, C, groups, nchunks,
                  float(eps), int(silu), _DTYPES[x.dtype], vectorized, stream)
    build.check(lib, code, "fused_group_norm")
    fused_group_norm.launches += 1
    note_launch("fused_group_norm", str(x.dtype), B, H, W, C, bool(silu))
    return y


fused_group_norm.launches = 0


def group_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               groups: int, eps: float = 1e-5, silu: bool = False,
               use_kernels: str = "auto") -> torch.Tensor:
    """Dispatch for a 4-D NHWC tensor: the kernel for a CUDA tensor, the
    plain version for a CPU tensor or under ``use_kernels='off'``."""
    if wants_kernel(use_kernels, x.is_cuda, "group_norm"):
        return fused_group_norm(x, weight, bias, groups, eps, silu)
    if x.is_cuda:
        group_norm.plain_cuda_calls += 1
    return reference_group_norm(x, weight, bias, groups, eps, silu)


group_norm.plain_cuda_calls = 0
