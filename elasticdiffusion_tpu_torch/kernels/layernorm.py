"""LayerNorm kernel wrapper: ``fused_layer_norm`` and ``reference_layer_norm``.

Replaces the Pallas TPU kernel ``fused_layer_norm`` / ``_ln_kernel`` of
``elasticdiffusion_tpu/kernels/layernorm.py`` with ``csrc/layernorm.cu``: one
read and one write of the row, fp32 statistics. The widths of the paths
(320, 640, 768, 1024, 1280) run a body instantiated for each width: the row
in registers, weight and bias in shared memory once a block, a persistent
grid. Other widths run a generic body. ``layernorm_plan`` says which.

Bound on this card: bytes (the activation read once and written once).

Both versions centre before squaring (``mean((x - mean)^2)``), as the TPU
kernel body does; the JAX package's own plain version uses
``E[x^2] - mean^2``, which agrees within 1e-6 in fp32.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import build, note_launch, wants_kernel

_DTYPES = {torch.bfloat16: 0, torch.float32: 1}


# widths with a body of their own (``ED_LN_ROWS`` in csrc/layernorm.cu):
# lanes that share a row in bf16 and in fp32, the most of 8, 16, 32 that
# divide the row's 16-byte chunks evenly
ROWS_WIDTHS = {320: (8, 16), 640: (16, 32), 768: (32, 32), 1024: (32, 32),
               1280: (32, 32)}
THREADS = 256


class LayerNormPlan(NamedTuple):
    """What one launch runs."""
    body: str             # 'rows' (a width of its own) or 'any'
    code: int             # the C entry's ``plan`` argument
    lanes_per_row: int
    chunks_per_lane: int  # 16-byte chunks a lane holds ('rows'); 0 for 'any'
    threads: int


def layernorm_plan(C: int, dtype: torch.dtype,
                   aligned: bool = True) -> LayerNormPlan:
    """The body of ``fused_layer_norm`` for a row of C channels; mirrors the
    instantiations of ``csrc/layernorm.cu``. ``aligned``: x, y, weight and
    bias start on 16 bytes."""
    if dtype not in _DTYPES:
        raise NotImplementedError(f"fused_layer_norm has no kernel for {dtype}")
    if C in ROWS_WIDTHS and aligned:
        lpr = ROWS_WIDTHS[C][_DTYPES[dtype]]
        vec = 16 // (2 if dtype == torch.bfloat16 else 4)
        return LayerNormPlan("rows", 1, lpr, C // (vec * lpr), THREADS)
    return LayerNormPlan("any", 0, 32, 0, 128)


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
    aligned = bool(vectorized and weight.data_ptr() % 16 == 0
                   and bias.data_ptr() % 16 == 0)
    plan = layernorm_plan(C, x.dtype, aligned)
    lib = build.load("layernorm")
    fn = lib.ed_layer_norm
    if not fn.argtypes:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong,
                       ctypes.c_int, ctypes.c_float, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = fn(x.data_ptr(), weight.data_ptr(), bias.data_ptr(), w_bf16,
                  y.data_ptr(), N, C, float(eps), _DTYPES[x.dtype], plan.code,
                  vectorized, stream)
    build.check(lib, code, "fused_layer_norm")
    fused_layer_norm.launches += 1
    note_launch("fused_layer_norm", str(x.dtype), str(weight.dtype), float(eps),
                N, C)
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
