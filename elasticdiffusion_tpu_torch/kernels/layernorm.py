"""LayerNorm kernel wrapper: ``fused_layer_norm`` and ``reference_layer_norm``.

Replaces the Pallas TPU kernel ``fused_layer_norm`` / ``_ln_kernel`` of
``elasticdiffusion_tpu/kernels/layernorm.py`` with ``csrc/layernorm.cu``: one
warp per row, one read and one write of the row, fp32 statistics.

Bound on this card: bytes (the activation read once and written once).

Both versions centre before squaring (``mean((x - mean)^2)``), as the TPU
kernel body does; the JAX package's own plain version uses
``E[x^2] - mean^2``, which agrees within 1e-6 in fp32.
"""

from __future__ import annotations

import ctypes

import torch

from . import build, note_launch, wants_kernel

_DTYPES = {torch.bfloat16: 0, torch.float32: 1}


def reference_layer_norm(x: torch.Tensor, weight: torch.Tensor,
                         bias: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Plain LayerNorm over the last dim: fp32 statistics and affine, output
    in ``x.dtype``."""
    xf = x.float()
    xc = xf - xf.mean(dim=-1, keepdim=True)
    var = (xc * xc).mean(dim=-1, keepdim=True)
    out = xc * torch.rsqrt(var + eps) * weight.float() + bias.float()
    return out.to(x.dtype)


def _param_flag(weight: torch.Tensor, bias: torch.Tensor, C: int) -> int:
    if weight.dtype != bias.dtype or weight.dtype not in _DTYPES:
        raise TypeError(f"weight/bias must both be fp32 or bf16, got "
                        f"{weight.dtype}, {bias.dtype}")
    if weight.shape != (C,) or bias.shape != (C,):
        raise ValueError(f"weight/bias must have shape ({C},)")
    if not (weight.is_contiguous() and bias.is_contiguous()):
        raise ValueError("weight/bias must be contiguous")
    return 1 if weight.dtype == torch.bfloat16 else 0


def fused_layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                     eps: float = 1e-5) -> torch.Tensor:
    """x: (..., C) bf16 or fp32 on the GPU; returns ``x.dtype``."""
    if not (x.is_cuda and weight.is_cuda and bias.is_cuda):
        raise RuntimeError("fused_layer_norm launches a CUDA kernel and needs "
                           "CUDA tensors")
    if x.dtype not in _DTYPES:
        raise TypeError(f"fused_layer_norm takes bf16 or fp32, got {x.dtype}")
    C = x.shape[-1]
    w_bf16 = _param_flag(weight, bias, C)
    if 4 * C * 4 > 200 * 1024:
        raise NotImplementedError(f"row of {C} channels exceeds the kernel's "
                                  f"shared-memory staging")
    x = x.contiguous()
    N = x.numel() // C
    y = torch.empty_like(x)
    vec = 16 // x.element_size()
    vectorized = int(C % vec == 0 and x.data_ptr() % 16 == 0
                     and y.data_ptr() % 16 == 0)
    lib = build.load("layernorm")
    fn = lib.ed_layer_norm
    if not fn.argtypes:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong,
                       ctypes.c_int, ctypes.c_float, ctypes.c_int,
                       ctypes.c_int, ctypes.c_void_p]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = fn(x.data_ptr(), weight.data_ptr(), bias.data_ptr(), w_bf16,
                  y.data_ptr(), N, C, float(eps), _DTYPES[x.dtype], vectorized,
                  stream)
    build.check(lib, code, "fused_layer_norm")
    fused_layer_norm.launches += 1
    note_launch("fused_layer_norm", str(x.dtype), N, C)
    return y


fused_layer_norm.launches = 0


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5, use_kernels: str = "auto") -> torch.Tensor:
    """Dispatch: the kernel for a CUDA tensor, the plain version for a CPU
    tensor or under ``use_kernels='off'``."""
    if wants_kernel(use_kernels, x.is_cuda, "layer_norm"):
        return fused_layer_norm(x, weight, bias, eps)
    if x.is_cuda:
        layer_norm.plain_cuda_calls += 1
    return reference_layer_norm(x, weight, bias, eps)


layer_norm.plain_cuda_calls = 0
