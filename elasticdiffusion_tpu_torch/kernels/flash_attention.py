"""Attention kernel wrapper: ``flash_attention`` and ``reference_attention``.

Replaces the Pallas TPU kernels of
``elasticdiffusion_tpu/kernels/flash_attention.py`` (``_oneshot_attention``,
``_flash_kernel_bf16_nn``, ``_flash_kernel``) with one CUDA C++ source,
``csrc/flash_attention.cu``: an online-softmax loop over key tiles in three
bodies. bf16 at head dim 64 (every UNet attention of SD 2.x and SDXL, self
and cross) and at head dims 40 / 80 / 160 (the SD 1.x UNet: 8 heads at 320 /
640 / 1280 channels; cut into slabs of 64 columns that the TMA load pads with
zeros) runs the body designed for Hopper: both products are ``wgmma``, K and
V arrive by TMA in a ring of shared-memory stages guarded by ``mbarrier``s, a
producer warpgroup loads while consumer warpgroups compute, and the softmax
stays in the accumulator registers. bf16 at head dim 512 (the VAE mid block
of the SD 1.x / 2.x decodes) runs a body of the same kind whose two consumer
warpgroups each own half of the head dim (a 64 x 512 fp32 accumulator is
more than one warpgroup can hold): each computes its half of S, the halves
meet in shared memory, and both run the same softmax; the keys are split
over blocks where the query rows cannot fill the card. fp32 at head dim 512
(the VAE mid block of the SDXL fp32 decode and the fp32 strip encodes) runs
a register-tiled body of full-precision FMAs (no TF32, as the JAX kernel's
``Precision.HIGHEST``): Q resident in shared memory, K and V streamed
through a ``cp.async`` ring, and the keys split the same way. Split keys
leave each split's (m, l, O) in a workspace, merged in split order by a
second kernel. fp32 at head dims 40 / 64 / 80 / 160 (every UNet attention
under ``--fp32``) runs both products on the tensor cores in three TF32
passes (each operand split as hi + lo in registers, ``mma.sync``), which
keep the fp32 products to a few units of their last place; K and V stream
through a ``cp.async`` ring.

Bound on this card: operations, ``4*B*H*Sq*Sk*D``, against the bf16 tensor
core peak (fp32: the CUDA-core peak, whatever the body runs on); for
cross-attention (Sk = 77) the q and output bytes. At head dim 64 the
exponentials of a key tile cost about as many cycles as its two products,
so the ``wgmma`` body overlaps them: see the source for how.
``attention_plan`` picks the body, its tile and the key splits as a pure
function of the shape.

Layout ``(B, S, H, D)``. Strided views are taken as they are when the last
dim is contiguous and the other strides keep 16-byte alignment (which is also
what a TMA tensor map asks of them).
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from . import build, note_launch

HEAD_DIMS = (40, 64, 80, 160, 512)
_LOG2E = 1.4426950408889634
_DTYPES = {torch.bfloat16: 0, torch.float32: 1}

# bf16 head dims of the wgmma body: (keys a tile, stages) of the 128-row
# block, stages of the 64-row block with 64-key tiles
WGMMA_TILES = {40: ((128, 3), 4), 64: ((128, 3), 4), 80: ((128, 3), 2),
               160: ((64, 3), 2)}
WGMMA_HEAD_DIMS = tuple(WGMMA_TILES)
SM_COUNT = 132            # H100 SXM
SMEM_PER_BLOCK = 232448   # bytes of shared memory one block may use
# the fp32 body at head dim 512: 64 query rows, 64-key tiles, a ring of 2
# slots; Q rows of 516 floats, slots of 64 x 132 floats, P rows of 68
# floats, and 64 floats of rescale factors (F512Cfg in
# csrc/flash_attention.cu)
F512_SMEM = (64 * 516 + 2 * 64 * 132 + 64 * 68 + 64) * 4
# the bf16 body at head dim 512: 64 query rows and 32-key tiles; Q (64 KB),
# two slots each of K and V tiles (32 KB a slot), the S exchange (32 KB),
# 1024 bytes of slack to align the tiles and 128 of barriers (W512Cfg in
# csrc/flash_attention.cu)
W512_SMEM = 1024 + 65536 + 4 * 32768 + 32768 + 128
MAX_KEY_SPLITS = 16
# the fp32 body at the UNet head dims: (keys a tile, stages of the ring)
# per head dim, in blocks of 4 warps of 16 query rows (ED_FLASH_F32 in
# csrc/flash_attention.cu)
TC_TILES = {40: (64, 2), 64: (64, 2), 80: (32, 2), 160: (32, 2)}


class AttentionPlan(NamedTuple):
    """What one launch runs: the body, its tile and what that costs."""
    body: str        # 'wgmma', 'wgmma.d512', 'fma.tiled' or 'mma.tf32x3'
    code: int        # the C entry's ``plan`` argument
    bm: int          # query rows of a block
    bn: int          # keys of a tile
    stages: int      # (K, V) tiles in flight in shared memory
    threads: int
    smem_bytes: int
    blocks: int      # grid size of the main kernel
    splits: int = 1  # blocks that share one query tile's keys


def key_splits(row_blocks: int, key_tiles: int) -> int:
    """Key splits of the D = 512 bodies, with ``key_tiles`` counted in
    tiles of 64 keys. A block's time is modelled as
    its key tiles plus half a tile for its prologue (Q, the ring's fill),
    the grid's as that times its waves of 132 blocks. At least 2 splits
    where the query rows alone leave SMs idle; a count replaces a smaller
    one only if it is 5 % faster by the model; at most one split a tile."""
    lo = 2 if row_blocks < SM_COUNT else 1
    best, best_cost = 1, None
    for s in range(lo, min(key_tiles, MAX_KEY_SPLITS) + 1):
        cost = -(-row_blocks * s // SM_COUNT) * (-(-key_tiles // s) + 0.5)
        if best_cost is None or cost < 0.95 * best_cost:
            best, best_cost = s, cost
    return best


def key_split_ranges(Sk: int, splits: int, bn: int = 64):
    """The keys ``[lo, hi)`` of each split, as the kernel cuts them: whole
    tiles of ``bn`` keys, the last one ragged."""
    T = -(-Sk // bn)
    return [(bn * (T * z // splits), min(Sk, bn * (T * (z + 1) // splits)))
            for z in range(splits)]


def attention_plan(dtype: torch.dtype, B: int, Sq: int, Sk: int, H: int,
                   D: int) -> AttentionPlan:
    """The body and tile of ``flash_attention`` for one shape; mirrors the
    configurations instantiated in ``csrc/flash_attention.cu``."""
    if dtype not in _DTYPES or D not in HEAD_DIMS:
        raise NotImplementedError(
            f"flash_attention has no kernel for {dtype}, head dim {D}")
    if dtype == torch.bfloat16 and D in WGMMA_TILES:
        (bn1, stages1), stages2 = WGMMA_TILES[D]
        if Sk <= 80:
            # the 77 text tokens: one tile of 80 keys, no ring, 64-row blocks
            # (the chain load, products, store is bound by latency)
            code, bm, bn, stages = 3, 64, 80, 1
        elif B * H * -(-Sq // 128) >= SM_COUNT:
            # two consumer warpgroups
            code, bm, bn, stages = 1, 128, bn1, stages1
        else:
            # 128-row blocks would leave SMs idle: one consumer warpgroup,
            # 64-key tiles
            code, bm, bn, stages = 2, 64, 64, stages2
        # slabs of 64 columns (128-byte rows) whatever D; 1024 bytes of slack
        # to align the tiles; 128 bytes of barriers
        nslab = -(-D // 64)
        smem = 1024 + nslab * 128 * (bm + stages * 2 * bn) + 128
        return AttentionPlan("wgmma", code, bm, bn, stages, 128 + 2 * bm, smem,
                             B * H * -(-Sq // bm))
    if D == 512:
        row_blocks = B * H * -(-Sq // 64)
        splits = key_splits(row_blocks, -(-Sk // 64))
        if dtype == torch.bfloat16:
            # two consumer warpgroups and a producer; K and V rings of 2
            return AttentionPlan("wgmma.d512", 5, 64, 32, 2, 384, W512_SMEM,
                                 row_blocks * splits, splits)
        return AttentionPlan("fma.tiled", 4, 64, 64, 2, 256, F512_SMEM,
                             row_blocks * splits, splits)
    # fp32 at D = 40, 64, 80, 160: Q and the ring's K and V tiles in rows of
    # D floats padded to 4 mod 32
    bn, stages = TC_TILES[D]
    bm, ld = 64, -(-D // 32) * 32 + 4
    smem = (bm + stages * 2 * bn) * ld * 4
    return AttentionPlan("mma.tf32x3", 0, bm, bn, stages, 128, smem,
                         B * H * -(-Sq // bm))


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


def split_key_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        splits: int, bn: int = 64) -> torch.Tensor:
    """Plain version of the split-key path of the D = 512 bodies: per split
    of the ``bn``-key tiles, the fp32 running max m, denominator l and
    unnormalised O of every row; merged in split order as
    sum_z w_z O_z / sum_z w_z l_z, w_z = exp(m_z - max_z m_z). P is rounded
    to ``v.dtype`` before P V inside each split (bf16: as the kernel rounds
    it; fp32: no rounding), while l sums the unrounded fp32 P."""
    D = q.shape[-1]
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / math.sqrt(D)
    parts = []
    for lo, hi in key_split_ranges(k.shape[1], splits, bn):
        lg = logits[..., lo:hi]
        m = lg.amax(-1, keepdim=True)
        p = torch.exp(lg - m)
        pv = p.to(v.dtype).float()
        parts.append((m, p.sum(-1, keepdim=True),
                      torch.einsum("bhqk,bkhd->bhqd", pv, v[:, lo:hi].float())))
    top = torch.stack([m for m, _, _ in parts]).amax(0)
    num = den = 0.0
    for m, l, o in parts:
        w = torch.exp(m - top)
        den = den + w * l
        num = num + w * o
    return (num / den).permute(0, 2, 1, 3).to(q.dtype)


def _strided_ok(t: torch.Tensor) -> bool:
    align = 16 // t.element_size()
    return (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all(s % align == 0 and (s > 0 or n == 1)
                    for n, s in zip(t.shape[:-1], t.stride()[:-1])))


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
                   f"(built: {HEAD_DIMS})")
    if D not in HEAD_DIMS:
        raise NotImplementedError(unsupported)
    plan = attention_plan(q.dtype, B, Sq, Sk, H, D)
    q, k, v = (t if _strided_ok(t) else t.contiguous() for t in (q, k, v))
    out = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
    # the key splits' fp32 partials: O (splits, B*Sq*H, D), then (m, l)
    ws = (torch.empty(plan.splits * B * Sq * H * (D + 2), dtype=torch.float32,
                      device=q.device) if plan.splits > 1 else None)
    lib = build.load("flash_attention")
    fn = lib.ed_flash_attention
    if not fn.argtypes:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                       + [ctypes.c_longlong] * 9
                       + [ctypes.c_int, ctypes.c_float, ctypes.c_int,
                          ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  B, Sq, Sk, H, D,
                  q.stride(0), q.stride(1), q.stride(2),
                  k.stride(0), k.stride(1), k.stride(2),
                  v.stride(0), v.stride(1), v.stride(2),
                  _DTYPES[q.dtype], _LOG2E / math.sqrt(D), plan.code,
                  plan.splits, ws.data_ptr() if ws is not None else None,
                  stream)
    build.check(lib, code, "flash_attention", unsupported)
    flash_attention.launches += 1
    note_launch("flash_attention", str(q.dtype), B, Sq, Sk, H, D)
    return out


flash_attention.launches = 0
