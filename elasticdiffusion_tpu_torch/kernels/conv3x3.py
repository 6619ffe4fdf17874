"""3x3 convolution kernel wrapper: ``conv3x3``, its plan and plain versions.

Replaces the Pallas TPU kernel ``conv3x3`` / ``_kernel`` of
``elasticdiffusion_tpu/kernels/conv3x3.py`` with ``csrc/conv3x3.cu``: a SAME
stride-1 3x3 NHWC convolution as an implicit matrix product, bias and
optional SiLU in the epilogue. The sum over the 9 taps and C is fp32 (one
accumulation, or fp32 partial sums added in a fixed order), the bias is
added in fp32, SiLU acts on the fp32 sum, and the result is rounded once to
``x.dtype``.

Bodies (``conv_plan`` picks one per shape, as a pure function of it):

  ``wgmma``     bf16: ``wgmma`` products on tiles that TMA loads into an
                ``mbarrier``-guarded ring, one box a tap with the SAME
                padding as TMA's zero fill; 128 or 256 pixels by 128 or 160
                output channels a tile (``conv_plan`` picks by a cost
                model), one persistent block an SM, and the K loop split
                (fp32 partial sums in a workspace, summed in split order by
                a second kernel) where the tiles cannot fill the card.
  ``mma.tf32x3`` fp32: the same implicit product on the tensor cores in
                three TF32 passes (each operand split as hi + lo in
                registers, ``mma.sync``), which keep the fp32 sums to a few
                units of their last place: 128 consecutive output pixels by
                64 output channels a tile, a ``cp.async`` ring whose zero
                fill is the SAME padding, the K loop split (the same
                workspace and sum kernel) where a cost model says the
                splits balance the SMs.

Bound on this card: operations, ``2*9*C*O*B*H*W``, against the bf16 tensor
core peak (fp32: the CUDA-core peak, whatever the body runs on). See the
source for what each design does about it.

Layout, as the JAX function: ``x (B, H, W, C)``, ``w (3, 3, C, O)``,
``bias (O,)``. Both operands are read through their strides when C, the
reduction dim, is contiguous: the NHWC view of a ``channels_last`` NCHW
activation and the HWIO view of a ``channels_last`` ``(O, C, 3, 3)`` weight
are taken in place. A tensor that does not satisfy that is copied, and
``conv3x3.copies`` counts those copies.

The gate is the part of the JAX package's gate that is about the function:
4-D input, 3x3 taps, ``C % 8 == 0`` and ``O % 8 == 0`` (16-byte rows). The
TPU's layout conditions (``W % 8``, a VMEM plan) are not carried over.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import build, note_launch

_DTYPES = {torch.bfloat16: 0, torch.float32: 1}
_BIAS_KINDS = {torch.float32: 1, torch.bfloat16: 2}

SM_COUNT = 132            # H100 SXM
SMEM_PER_BLOCK = 232448   # bytes of shared memory one block may use
# the bf16 wgmma body, as ``ed_conv3x3`` in csrc/conv3x3.cu instantiates it:
# plan code -> (output channels a tile, stages of the ring, 64-row
# accumulators a consumer warpgroup: 128 or 256 pixels a tile); K iterations
# of 64 channels x one tap
WGMMA_TILES = {1: (128, 6, 1), 2: (160, 5, 1), 3: (128, 4, 2),
               4: (160, 4, 2)}
MAX_SPLITS = 16
# the fp32 body (TcConvCfg in csrc/conv3x3.cu): 128 consecutive pixels by 64
# output channels a tile, K iterations of 32 channels x one tap through a
# ring of 3 stages of rows padded to 40 floats, 256 threads, two blocks an SM
TC_BM, TC_BN, TC_BK, TC_STAGES, TC_LD = 128, 64, 32, 3, 40


class ConvPlan(NamedTuple):
    """What one launch of ``conv3x3`` runs: the body, its tile and cost."""
    body: str        # 'wgmma' (bf16) or 'mma.tf32x3' (fp32)
    code: int        # the C entry's ``plan`` argument
    tile: tuple      # pixels of a tile: (along W, along H, images); the
                     # fp32 body's (128, 1, 1) is 128 consecutive pixels
    bn: int          # output channels of a tile
    stages: int      # tiles in flight in shared memory (1: none)
    splits: int      # work items that share one output tile's K loop
    threads: int
    smem_bytes: int
    blocks: int      # grid size of the main kernel
    items: int = 1   # work items (output tiles x splits) the grid walks


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


# A cost model of the wgmma body, used only to choose among its plans:
# microseconds a K iteration and a tile (prologue, epilogue) of each
# instantiation, fitted by hand to the body's device times on an H100 at the
# path shapes (PERF.md); the 256-pixel tiles load less per product
_ITER_US = {1: 0.40, 2: 0.478, 3: 0.668, 4: 0.841}
_TILE_US = {1: 9.8, 2: 12.2, 3: 18.5, 4: 21.1}


def _est_us(code: int, tiles: int, kiters: int, splits: int,
            MO: int) -> float:
    """Waves of work items over 132 SMs times one item's time, plus the
    split sum's fp32 traffic at about 2.5 TB/s and its launch."""
    t = _ceil(tiles * splits, SM_COUNT) * (
        _TILE_US[code] + _ceil(kiters, splits) * _ITER_US[code])
    if splits > 1:
        t += splits * MO * 8 / 2.5e6 + 3.0
    return t


def _pixel_tile(bm: int, B: int, H: int, W: int) -> tuple:
    """(along W, along H, images) of a bm-pixel tile that follows the image:
    16 wide, or 8 wide with several images where the image is 8 wide or
    less; 8 or 16 rows."""
    tw = 16 if W > 8 or B == 1 else 8
    th = 16 if bm // tw >= 16 and H > 8 else 8
    return tw, th, bm // (tw * th)


def wgmma_plan(code: int, B: int, H: int, W: int, C: int, O: int) -> ConvPlan:
    """The plan of one instantiation of the wgmma body (``code`` of
    ``WGMMA_TILES``) for one shape: its pixel tile and K splits."""
    bn, stages, mt = WGMMA_TILES[code]
    bm = 128 * mt
    tile = _pixel_tile(bm, B, H, W)
    tiles = (_ceil(W, tile[0]) * _ceil(H, tile[1]) * _ceil(B, tile[2])
             * _ceil(O, bn))
    kiters = 9 * _ceil(C, 64)
    # split the K loop only where the tiles cannot fill the card, and then
    # always; each split keeps at least one channel chunk (9 taps)
    splits = 1
    if tiles < SM_COUNT and kiters // 9 >= 2:
        splits = min(range(2, min(MAX_SPLITS, kiters // 9) + 1),
                     key=lambda z: (_est_us(code, tiles, kiters, z,
                                            B * H * W * O), z))
    smem = 1024 + stages * (bm + bn) * 128 + 128
    # persistent: at most one block an SM, walking over the work items
    return ConvPlan("wgmma", code, tile, bn, stages, splits, 384, smem,
                    min(tiles * splits, SM_COUNT), tiles * splits)


# A cost model of the fp32 body, used only to choose its K splits: an SM's
# microseconds for one K iteration of one work item while two or more share
# it (two blocks are resident), fitted by hand to the body's device times on
# an H100 at the path shapes (PERF.md); of one item alone on an SM, an
# estimate (two thirds of the shared rate); and of an item's prologue and
# epilogue
_TC_ITER_US, _TC_ALONE_ITER_US, _TC_ITEM_US = 1.6, 2.4, 2.0


def _tc_est_us(tiles: int, kiters: int, splits: int, MO: int) -> float:
    """The SM that gets the most work items runs them at its shared rate
    (a lone item at its own), plus the split sum's fp32 traffic at about
    2.5 TB/s and its launch."""
    k = _ceil(tiles * splits, SM_COUNT)
    it = _ceil(kiters, splits)
    t = (k * _TC_ITER_US if k > 1 else _TC_ALONE_ITER_US) * it \
        + k * _TC_ITEM_US
    if splits > 1:
        t += (splits + 1) * MO * 4 / 2.5e6 + 3.0
    return t


def tc_plan(B: int, H: int, W: int, C: int, O: int) -> ConvPlan:
    """The plan of the fp32 body: its tiles and K splits. The K loop splits
    only where the tiles cannot fill both block places of every SM (under
    264: the small latents, and 160 tiles on 132 SMs), into the count the
    cost model rates fastest: a count replaces a smaller one only if it is
    5 % faster, and each split keeps at least 9 iterations (one chunk of
    every tap)."""
    tiles = _ceil(B * H * W, TC_BM) * _ceil(O, TC_BN)
    kiters = 9 * _ceil(C, TC_BK)
    cost = lambda z: _tc_est_us(tiles, kiters, z, B * H * W * O)
    splits = 1
    if tiles < 2 * SM_COUNT:
        for z in range(2, min(MAX_SPLITS, kiters // 9) + 1):
            if cost(z) < 0.95 * cost(splits):
                splits = z
    smem = TC_STAGES * (TC_BM + TC_BN) * TC_LD * 4
    return ConvPlan("mma.tf32x3", 0, (TC_BM, 1, 1), TC_BN, TC_STAGES, splits,
                    256, smem, tiles * splits, tiles * splits)


def conv_plan(dtype: torch.dtype, B: int, H: int, W: int, C: int,
              O: int) -> ConvPlan:
    """The body, tile and K splits of ``conv3x3`` for one shape; mirrors
    the configurations instantiated in ``csrc/conv3x3.cu``. A pure function
    of its arguments."""
    if dtype not in _DTYPES:
        raise NotImplementedError(f"conv3x3 has no kernel for {dtype}")
    if not (C % 8 == 0 and O % 8 == 0 and min(B, H, W, C, O) >= 1):
        raise ValueError(f"conv3x3 takes C and O multiples of 8, got {C}, {O}")
    if dtype == torch.float32:
        return tc_plan(B, H, W, C, O)

    def cost(plan):
        return (_est_us(plan.code, plan.items // plan.splits,
                        9 * _ceil(C, 64), plan.splits, B * H * W * O),
                plan.splits, -plan.bn)
    return min((wgmma_plan(code, B, H, W, C, O) for code in WGMMA_TILES),
               key=cost)


def split_ranges(kiters: int, splits: int):
    """The K iterations ``[lo, hi)`` of each split, as the kernel cuts them."""
    return [(kiters * z // splits, kiters * (z + 1) // splits)
            for z in range(splits)]


def in_gate(x_shape, w_shape) -> bool:
    """Whether ``conv3x3`` takes x (B, H, W, C) with w (3, 3, C, O)."""
    if len(x_shape) != 4 or len(w_shape) != 4:
        return False
    C, (kh, kw, Cw, O) = x_shape[-1], w_shape
    return (kh, kw, Cw) == (3, 3, C) and C % 8 == 0 and O % 8 == 0


def _conv_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (B, H, W, C), w (3, 3, C, O) -> the fp32 sums (B, H, W, O), no TF32;
    on the CPU under the rule of ``models.layers.conv2d``."""
    from ..models.layers import conv2d  # layers imports this module
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        out = conv2d(x.permute(0, 3, 1, 2).float(),
                     w.permute(3, 2, 0, 1).float(), padding=1)
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    return out.permute(0, 2, 3, 1)


def _epilogue(acc: torch.Tensor, bias, silu_out: bool, dtype) -> torch.Tensor:
    if bias is not None:
        acc = acc + bias.float()
    if silu_out:
        acc = acc * torch.sigmoid(acc)
    return acc.to(dtype)


def reference_conv3x3(x: torch.Tensor, w: torch.Tensor,
                      bias: torch.Tensor | None = None,
                      silu_out: bool = False) -> torch.Tensor:
    """Plain version that defines the numbers: operands upcast to fp32, the
    convolution, the bias and SiLU in full fp32 (no TF32), one cast to
    ``x.dtype``. x (B, H, W, C), w (3, 3, C, O) -> (B, H, W, O)."""
    return _epilogue(_conv_f32(x, w), bias, silu_out, x.dtype)


def split_k_conv3x3(x: torch.Tensor, w: torch.Tensor,
                    bias: torch.Tensor | None = None, silu_out: bool = False,
                    splits: int = 1, chunk: int = 64) -> torch.Tensor:
    """Plain version of the split-K path of both bodies: the K loop
    (``chunk``-channel chunks x 9 taps, taps fastest: 64 channels in the
    ``wgmma`` body, 32 in the fp32 one) cut into ``splits`` ranges as the
    kernel cuts it, an fp32 partial sum per range, the partials added in
    split order, then the bias and SiLU in fp32 and one rounding."""
    C = x.shape[-1]
    kiters = 9 * _ceil(C, chunk)
    total = None
    for lo, hi in split_ranges(kiters, splits):
        mask = torch.zeros(9, C, dtype=torch.float32, device=w.device)
        for it in range(lo, hi):
            c, tap = divmod(it, 9)
            mask[tap, c * chunk:(c + 1) * chunk] = 1.0
        part = _conv_f32(x, w.float() * mask.view(3, 3, C, 1))
        total = part if total is None else total + part
    return _epilogue(total, bias, silu_out, x.dtype)


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
    plan = conv_plan(x.dtype, B, H, W, C, O)
    y = torch.empty((B, H, W, O), dtype=x.dtype, device=x.device)
    # fp32 partial sums of the K splits: (splits, B*H*W, O)
    ws = (torch.empty(plan.splits * B * H * W * O, dtype=torch.float32,
                      device=x.device) if plan.splits > 1 else None)
    lib = build.load("conv3x3")
    fn = lib.ed_conv3x3
    if not fn.argtypes:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                       + [ctypes.c_longlong] * 6 + [ctypes.c_int] * 8
                       + [ctypes.c_void_p] * 2)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = fn(x.data_ptr(), w.data_ptr(),
                  bias.data_ptr() if bias is not None else None, y.data_ptr(),
                  B, H, W, C, O, x.stride(0), x.stride(1), x.stride(2),
                  w.stride(0), w.stride(1), w.stride(3),
                  bias_kind, int(silu_out), _DTYPES[x.dtype], plan.code,
                  *plan.tile, plan.splits,
                  ws.data_ptr() if ws is not None else None, stream)
    build.check(lib, code, "conv3x3")
    conv3x3.launches += 1
    note_launch("conv3x3", str(x.dtype), B, H, W, C, O, bool(silu_out))
    return y


conv3x3.launches = 0
# times an operand did not have C contiguous and was copied first
conv3x3.copies = 0
