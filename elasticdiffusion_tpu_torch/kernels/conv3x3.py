"""3x3 convolution kernel wrapper: ``conv3x3`` and ``reference_conv3x3``.

Replaces the Pallas TPU kernel ``conv3x3`` / ``_kernel`` of
``elasticdiffusion_tpu/kernels/conv3x3.py`` with ``csrc/conv3x3.cu``: a SAME
stride-1 3x3 NHWC convolution as an implicit matrix product, tensor cores
(``mma.sync``) for bf16 and full-precision FMAs for fp32, bias and optional
SiLU in the epilogue. The sum over the 9 taps and C is one fp32
accumulation, the bias is added in fp32, SiLU acts on the fp32 sum, and the
result is rounded once to ``x.dtype``.

Bound on this card: operations, ``2*9*C*O*B*H*W``, against the bf16 tensor
core peak (fp32: the CUDA-core peak). See the source for what the design
does about it.

Layout, as the JAX function: ``x (B, H, W, C)``, ``w (3, 3, C, O)``,
``bias (O,)``. Both operands are read through their strides when C, the
reduction dim, is contiguous: the NHWC view of a ``channels_last`` NCHW
activation and the HWIO view of a ``channels_last`` ``(O, C, 3, 3)`` weight
are taken in place. A tensor that does not satisfy that is copied, and
``conv3x3.copies`` counts those copies.

The gate is the part of the JAX package's gate that is about the function:
4-D input, 3x3 taps, ``C % 8 == 0`` and ``O % 8 == 0`` (16-byte loads). The
TPU's layout conditions (``W % 8``, a VMEM plan) are not carried over.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import build, note_launch

_DTYPES = {torch.bfloat16: 0, torch.float32: 1}
_BIAS_KINDS = {torch.float32: 1, torch.bfloat16: 2}


def in_gate(x_shape, w_shape) -> bool:
    """Whether ``conv3x3`` takes x (B, H, W, C) with w (3, 3, C, O)."""
    if len(x_shape) != 4 or len(w_shape) != 4:
        return False
    C, (kh, kw, Cw, O) = x_shape[-1], w_shape
    return (kh, kw, Cw) == (3, 3, C) and C % 8 == 0 and O % 8 == 0


def reference_conv3x3(x: torch.Tensor, w: torch.Tensor,
                      bias: torch.Tensor | None = None,
                      silu_out: bool = False) -> torch.Tensor:
    """Plain version that defines the numbers: operands upcast to fp32, the
    convolution, the bias and SiLU in full fp32 (no TF32), one cast to
    ``x.dtype``. x (B, H, W, C), w (3, 3, C, O) -> (B, H, W, O)."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        out = F.conv2d(x.permute(0, 3, 1, 2).float(),
                       w.permute(3, 2, 0, 1).float(), padding=1)
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    out = out.permute(0, 2, 3, 1)
    if bias is not None:
        out = out + bias.float()
    if silu_out:
        out = out * torch.sigmoid(out)
    return out.to(x.dtype)


def _aligned(t: torch.Tensor, strides) -> bool:
    align = 16 // t.element_size()
    return t.data_ptr() % 16 == 0 and all(s % align == 0 for s in strides)


def conv3x3(x: torch.Tensor, w: torch.Tensor,
            bias: torch.Tensor | None = None,
            silu_out: bool = False) -> torch.Tensor:
    """x (B, H, W, C), w (3, 3, C, O), bias (O,) or None -> (B, H, W, O) in
    ``x.dtype``, on the GPU. Launches the kernel or raises."""
    if not (x.is_cuda and w.is_cuda and (bias is None or bias.is_cuda)):
        raise RuntimeError("conv3x3 launches a CUDA kernel and needs CUDA "
                           "tensors")
    if x.dtype not in _DTYPES or w.dtype != x.dtype:
        raise TypeError(f"conv3x3 takes bf16 or fp32 x and w of one type, got "
                        f"{x.dtype}, {w.dtype}")
    if not in_gate(x.shape, w.shape):
        raise ValueError(f"conv3x3 takes x (B,H,W,C) and w (3,3,C,O) with C "
                         f"and O multiples of 8, got {tuple(x.shape)}, "
                         f"{tuple(w.shape)}")
    B, H, W, C = x.shape
    O = w.shape[-1]
    if min(B, H, W) < 1:
        raise ValueError(f"empty input {tuple(x.shape)}")
    bias_kind = 0
    if bias is not None:
        if bias.dtype not in _BIAS_KINDS or bias.shape != (O,):
            raise TypeError(f"bias must be fp32 or bf16 of shape ({O},), got "
                            f"{bias.dtype} {tuple(bias.shape)}")
        bias_kind = _BIAS_KINDS[bias.dtype]
        bias = bias.contiguous()
    # the reduction dim C contiguous in both operands, 16-byte aligned rows
    if not (x.stride(3) == 1 and _aligned(x, x.stride()[:3])):
        x = x.contiguous()
        conv3x3.copies += 1
    if not (w.stride(2) == 1 and _aligned(w, (w.stride(0), w.stride(1),
                                              w.stride(3)))):
        w = w.permute(3, 0, 1, 2).contiguous().permute(1, 2, 3, 0)
        conv3x3.copies += 1
    y = torch.empty((B, H, W, O), dtype=x.dtype, device=x.device)
    lib = build.load("conv3x3")
    fn = lib.ed_conv3x3
    if not fn.argtypes:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                       + [ctypes.c_longlong] * 6 + [ctypes.c_int] * 3
                       + [ctypes.c_void_p])
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = fn(x.data_ptr(), w.data_ptr(),
                  bias.data_ptr() if bias is not None else None, y.data_ptr(),
                  B, H, W, C, O, x.stride(0), x.stride(1), x.stride(2),
                  w.stride(0), w.stride(1), w.stride(3),
                  bias_kind, int(silu_out), _DTYPES[x.dtype], stream)
    build.check(lib, code, "conv3x3")
    conv3x3.launches += 1
    note_launch("conv3x3", str(x.dtype), B, H, W, C, O, bool(silu_out))
    return y


conv3x3.launches = 0
# times an operand did not have C contiguous and was copied first
conv3x3.copies = 0
