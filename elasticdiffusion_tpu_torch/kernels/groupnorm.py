"""GroupNorm(+SiLU) kernel wrapper: ``fused_group_norm``, its plan and its
plain versions.

Replaces the Pallas TPU kernels ``fused_group_norm`` / ``_stats_kernel`` /
``_apply_kernel`` of ``elasticdiffusion_tpu/kernels/groupnorm.py`` with
``csrc/groupnorm.cu``. Three bodies, chosen by ``groupnorm_plan``:

  'cluster'   one launch, one read and one write. A cluster of 1-16 blocks
              owns one (image, span of groups) slab at a time; each block
              stages its rows of the slab in shared memory, the blocks add
              their group sums through distributed shared memory in rank
              order, and each normalises its rows from shared memory. The
              grid is persistent. The small and middle UNet shapes take it.
  'grid'      one launch: B x K blocks, one an SM, all resident at once
              (a cooperative launch). A block owns whole rows of one image,
              keeps as many of them as fit in shared memory, streams the
              others through registers for the sums, meets the image's other
              blocks at a counter, and normalises: the streamed rows read
              again (the most recent from L2), then the resident ones. Where
              every row stays resident it reads once. The large UNet shapes,
              the VAE decoders and the strip encodes take it.
  'two_pass'  two launches, for what neither takes (rows of more than 512
              chunks, unaligned or ragged rows too large for a cluster):
              per-channel partial sums over row chunks, the last block of an
              image turning them into scale and shift, then the elementwise
              apply in reverse row order, so that the rows read last are read
              again first, from L2.

The two-pass body's halves are also entries of their own:
``group_norm_sums`` (per-channel sums of a tensor or a window of rows) and
``group_norm_apply`` (``x * scale + shift`` and SiLU with per-image,
per-channel fp32 scale and shift). The streamed decode of
``parallel/halo_decode.py`` takes GroupNorm's moments of a whole tensor
window by window from the first, turns them into scale and shift in torch
(``group_scale_shift``) and normalises each window with the second.

No sum is taken with atomics, so results repeat from run to run.
``split_group_norm`` is the plain version of the bodies' order of sums.

Bound on this card: bytes (the activation read once and written once).

Input ``(B, H, W, C)``, the NHWC view that a ``channels_last`` NCHW tensor
gives for free. fp32 statistics with ``var = E[x^2] - E[x]^2``, output in the
input dtype, weight and bias in fp32 or bf16.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from . import build, note_launch, wants_kernel
from .layernorm import _DTYPES, _param_flag

# mirrors csrc/groupnorm.cu
THREADS = 256
SMEM_MAX = 232448          # dynamic shared memory a block may have (227 KB)
SMEM_SM = 233472           # shared memory of an SM (228 KB)
CLUSTERS = (1, 2, 4, 8, 16)  # 16 is not portable: the card is asked first
# Clusters the H100 holds at once, for each block an SM the cluster's shared
# memory leaves room for (cudaOccupancyMaxActiveClusters, as chip_smoke.py
# prints it per case; at most 3 blocks an SM counted for clusters of 4-16)
HELD = {1: 132, 2: 66, 4: 30.5, 8: 15, 16: 7}
BOX_ROWS = 64              # rows a TMA box (16-byte chunks move by TMA)
GRID_THREADS = 512         # threads a block of the grid body
SMS = 132                  # SMs of the H100: blocks the grid body may hold
STATS_BLOCKS = 264         # two-pass statistics blocks to aim for: 2 an SM
UNROLL = 8                 # rows a thread has in flight in the two-pass body
APPLY_BYTES = 32 * 1024    # bytes a two-pass apply block moves
SUM_BLOCK = 1 << 14        # elements of a group the plain version sums at once


class GroupNormPlan(NamedTuple):
    """What one call runs."""
    body: str          # 'cluster' or 'two_pass'
    code: int          # the C entry's ``plan`` argument: 1 cluster, 2 two-pass,
                       # 3 grid
    vec: int           # bytes a thread moves at a time (16; two-pass also
                       # the element size, for rows of other widths)
    cluster: int       # blocks a cluster (1 for the other bodies)
    span: int          # channels a slab covers: whole groups (others: C)
    rows_per_cta: int  # rows of the slab a block holds; grid: rows a block
                       # owns; two-pass: rows a statistics block sums
    smem_bytes: int    # dynamic shared memory a block
    blocks: int        # cluster: slabs x cluster size (the launch holds at
                       # most the clusters the card fits at once); grid: the
                       # blocks; two-pass: blocks of the statistics launch


def _cluster_smem(rows: int, span: int, elt: int, groups: int) -> int:
    """Shared memory of one cluster-body block: 128 bytes of barrier, its
    rows of the slab, then the fp32 reduction scratch (per-thread sums,
    partition sums, the block's group sums by parity, the cluster's group
    sums)."""
    span_bytes = span * elt
    nch, ncol = span_bytes // 16, 2 * span
    data = -(-rows * span_bytes // 128) * 128
    return 128 + data + 4 * ((THREADS // nch) * ncol
                             + max(1, THREADS // ncol) * ncol + 6 * groups)


def _cluster_seconds(units: int, c: int, data: int, smem: int) -> float:
    """Modelled time of a cluster-body launch: the persistent grid walks the
    slabs in rounds of as many clusters as the card holds; a round moves
    each block's rows in and out at up to 25 GB/s a block and 2.6 TB/s in
    all, and pays 3.5 us + 0.7 us x log2(cluster) of reductions and cluster
    barrier. Fitted to H100 device times of each cluster size forced at the
    main path shapes; it only ranks cluster sizes."""
    per_sm = min(8, SMEM_SM // (smem + 1024))
    held = max(1, int(HELD[c] * (per_sm if c <= 2 else min(per_sm, 3))))
    t = 0.0
    while units > 0:
        blocks = min(held, units) * c
        t += (2 * blocks * data / min(2.6e12, blocks * 25e9)
              + 3.5e-6 + 0.7e-6 * math.log2(c))
        units -= held
    return t


def _grid_plan(dtype: torch.dtype, B: int, S: int, C: int, G: int):
    """(plan, rows it keeps resident) of the grid body, or None where the
    grid body cannot run: K = SMS // B blocks an image (one an SM, all
    resident at once), each with as many of its rows in shared memory as
    fit beside the reduction scratch."""
    elt = 2 if dtype == torch.bfloat16 else 4
    cv = C * elt // 16
    if C * elt % 16 or cv > GRID_THREADS or B > SMS:
        return None
    K = max(1, min(SMS // B, S // BOX_ROWS))
    rows = -(-S // K)
    scratch = 4 * ((GRID_THREADS // cv) * 2 * C + 2 * C + 2 * G) + 16
    smem = min(SMEM_MAX, scratch + rows * C * elt)
    plan = GroupNormPlan("grid", 3, 16, 1, C, rows, smem, B * K)
    return plan, min(rows, (smem - scratch) // (C * elt))


def _two_pass_shape(C: int, elt: int, vec: int):
    """(TX, TY, ZC): threads along the channel vectors, along the rows, and
    blocks along C, of the two-pass kernels."""
    cv = C * elt // vec
    tx = min(cv, THREADS)
    return tx, THREADS // tx, -(-cv // tx)


def _cluster_plan(elt: int, B: int, S: int, C: int, G: int, align: int):
    """The cluster body's plan, or None where no cluster holds a slab."""
    gs = C // G
    if align < 16:
        return None
    for width in (32, 16):
        sg = next((n for n in range(1, G + 1)
                   if G % n == 0 and n * gs * elt % width == 0), None)
        if sg is None:
            continue
        span = sg * gs
        if span > 256:  # a TMA box is at most 256 elements wide
            continue
        if width < 32 and span * elt < 64:
            continue  # most of its sectors split: two passes move more
        units = B * (G // sg)
        best = None
        for c in CLUSTERS:
            if c > S:
                break
            rows = -(-S // c)
            rows = -(-rows // BOX_ROWS) * BOX_ROWS  # whole TMA boxes
            smem = _cluster_smem(rows, span, elt, sg)
            if smem > SMEM_MAX:
                continue
            t = _cluster_seconds(units, c, rows * span * elt, smem)
            if best is None or t < best[0]:
                best = (t, c, rows, smem)
        if best is not None:
            _, c, rows, smem = best
            return GroupNormPlan("cluster", 1, 16, c, span, rows, smem,
                                 units * c)
    return None


@functools.lru_cache(maxsize=1024)
def groupnorm_plan(dtype: torch.dtype, B: int, S: int, C: int, G: int,
                   w_dtype: torch.dtype = None, align: int = 16) -> GroupNormPlan:
    """The body of ``fused_group_norm`` for B images of S = H*W rows of C
    channels in G groups; mirrors csrc/groupnorm.cu. ``w_dtype``: the dtype
    of weight and bias (fp32 or bf16; every body takes both). ``align``: the
    largest power of two up to 16 that divides the addresses of x and y.

    The cluster body takes the first span width that fits a cluster of at
    most 16 blocks: spans a whole number of 32-byte sectors wide (a sector
    split between two blocks halves the rate at which both move it), then
    of 16-byte chunks if such a span is at least 64 bytes wide; both are
    loaded by TMA in boxes of BOX_ROWS rows. Of the cluster sizes that fit
    it takes the one ``_cluster_seconds`` rates fastest.

    The grid body (whole rows, so no sector is split) takes its place where
    a cluster needs 16 blocks or none fits, and where at least half of a
    block's rows stay resident, at least 64 blocks run and a row is at most
    256 chunks (so that two threads or more share a chunk column): on the
    H100 it was the faster there, and the cluster body elsewhere. Shapes
    neither takes run two passes."""
    if dtype not in _DTYPES:
        raise NotImplementedError(f"fused_group_norm has no kernel for {dtype}")
    if w_dtype is not None and w_dtype not in _DTYPES:
        raise TypeError(f"weight/bias must be fp32 or bf16, got {w_dtype}")
    if C % G:
        raise ValueError(f"{C} channels do not split into {G} groups")
    elt = 2 if dtype == torch.bfloat16 else 4
    cluster = _cluster_plan(elt, B, S, C, G, align)
    grid = _grid_plan(dtype, B, S, C, G) if align >= 16 else None
    if grid is not None:
        plan, resident = grid
        if (cluster is None or cluster.cluster == 16
                or (C * elt <= 256 * 16 and plan.blocks >= 64
                    and 2 * resident >= plan.rows_per_cta)):
            return plan
    if cluster is not None:
        return cluster
    return _two_pass_plan(elt, B, S, C, G, align)


def _two_pass_plan(elt: int, B: int, S: int, C: int, G: int,
                   align: int) -> GroupNormPlan:
    """The two-pass body's plan; its statistics launch alone with G = 0
    (``group_norm_sums``)."""
    vec = 16 if (C * elt % 16 == 0 and align >= 16) else elt
    tx, ty, zc = _two_pass_shape(C, elt, vec)
    nchunks = max(1, min(-(-STATS_BLOCKS // (B * zc)), -(-S // (ty * UNROLL))))
    rows = -(-S // nchunks)
    smem = 4 * max(ty * tx * 2 * (vec // elt), 2 * C + 2 * G)
    return GroupNormPlan("two_pass", 2, vec, 1, C, rows, smem,
                         -(-S // rows) * B * zc)


def reference_group_norm(x: torch.Tensor, weight: torch.Tensor,
                         bias: torch.Tensor, groups: int, eps: float = 1e-5,
                         silu: bool = False) -> torch.Tensor:
    """Plain NHWC GroupNorm, on the JAX package's formula. The moments are
    summed over blocks of rows of at most ``SUM_BLOCK`` elements of a group,
    then over the blocks, as the kernel sums its blocks' partials: torch's
    CPU sum of a whole group of the SD VAE's 1x256x512x128 at once is about
    twenty times less exact than XLA's (tests/test_torch_port_full_width.py
    holds this version to a float64 GroupNorm)."""
    shape = x.shape
    B, C = shape[0], shape[-1]
    gs = C // groups
    xg = x.float().reshape(B, -1, groups, gs)
    rows = max(1, SUM_BLOCK // gs)
    s = q = 0
    for r0 in range(0, xg.shape[1], rows):
        part = xg[:, r0:r0 + rows]
        s = s + part.sum(dim=(1, 3), keepdim=True)
        q = q + (part * part).sum(dim=(1, 3), keepdim=True)
    n = xg.shape[1] * gs
    mean = s / n
    var = q / n - mean * mean
    out = (xg - mean) * torch.rsqrt(var + eps)
    out = out.reshape(shape) * weight.float() + bias.float()
    if silu:
        out = out * torch.sigmoid(out)
    return out.to(x.dtype)


def reference_group_norm_sums(x: torch.Tensor) -> torch.Tensor:
    """Plain version of ``group_norm_sums``: (B, 2, C) fp32, the sum and
    the sum of squares of each image's channels over its rows."""
    xf = x.float().reshape(x.shape[0], -1, x.shape[-1])
    return torch.stack([xf.sum(dim=1), (xf * xf).sum(dim=1)], dim=1)


def reference_group_norm_apply(x: torch.Tensor, scale: torch.Tensor,
                               shift: torch.Tensor,
                               silu: bool = False) -> torch.Tensor:
    """Plain version of ``group_norm_apply``: ``x * scale + shift`` in
    fp32 with (B, C) fp32 scale and shift, then SiLU; in x's dtype."""
    B, C = x.shape[0], x.shape[-1]
    bc = (B,) + (1,) * (x.dim() - 2) + (C,)
    out = x.float() * scale.reshape(bc) + shift.reshape(bc)
    if silu:
        out = out * torch.sigmoid(out)
    return out.to(x.dtype)


def group_scale_shift(sums: torch.Tensor, count: int, weight: torch.Tensor,
                      bias: torch.Tensor, groups: int, eps: float):
    """(B, 2, C) channel sums over ``count`` rows -> the (B, C) fp32
    ``scale``, ``shift`` of GroupNorm: group moments
    ``var = E[x^2] - E[x]^2``, ``scale = w * rsqrt(var + eps)``,
    ``shift = b - mean * scale``. The step between the two halves, in
    torch on the tensor's device, as the JAX kernel keeps it in jnp."""
    B, _, C = sums.shape
    gs = C // groups
    g = sums.reshape(B, 2, groups, gs).sum(dim=-1)
    cnt = float(count * gs)
    mean = g[:, 0] / cnt
    var = g[:, 1] / cnt - mean * mean
    scale = weight.float() * torch.rsqrt(var + eps).repeat_interleave(gs, dim=-1)
    shift = bias.float() - mean.repeat_interleave(gs, dim=-1) * scale
    return scale, shift


def split_group_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                     groups: int, eps: float = 1e-5, silu: bool = False,
                     plan: GroupNormPlan = None) -> torch.Tensor:
    """Plain version of the kernel's order of sums, in fp32. Each block sums
    ``plan.rows_per_cta`` rows per channel. The cluster body adds a block's
    channel sums into group sums and then the blocks' group sums in rank
    order; the grid and two-pass bodies add the blocks' channel sums in
    block order and then the channels of each group. Then
    ``scale = w * rsqrt(var + eps)``, ``shift = b - mean * scale``,
    ``x * scale + shift`` (and SiLU)."""
    B, H, W, C = x.shape
    S = H * W
    if plan is None:
        plan = groupnorm_plan(x.dtype, B, S, C, groups, weight.dtype)
    gs = C // groups
    xf = x.float().reshape(B, S, C)
    s = torch.zeros(B, groups if plan.body == "cluster" else C, device=x.device)
    q = torch.zeros_like(s)
    for r0 in range(0, S, plan.rows_per_cta):
        part = xf[:, r0:r0 + plan.rows_per_cta]
        ps, pq = part.sum(dim=1), (part * part).sum(dim=1)
        if plan.body == "cluster":
            ps, pq = (t.reshape(B, groups, gs).sum(-1) for t in (ps, pq))
        s, q = s + ps, q + pq
    if plan.body != "cluster":
        s, q = (t.reshape(B, groups, gs).sum(-1) for t in (s, q))
    cnt = float(S * gs)
    mean = s / cnt
    var = q / cnt - mean * mean
    inv = torch.rsqrt(var + eps)
    scale = weight.float() * inv.repeat_interleave(gs, dim=-1)
    shift = bias.float() - mean.repeat_interleave(gs, dim=-1) * scale
    out = xf * scale[:, None] + shift[:, None]
    if silu:
        out = out * torch.sigmoid(out)
    return out.to(x.dtype).reshape(B, H, W, C)


def _align(*ptrs: int) -> int:
    a = 16
    while a > 1 and any(p % a for p in ptrs):
        a //= 2
    return a


_counters = {}  # device -> int32 zeros: blocks done (and gone), per image


def _counter(device: torch.device, B: int) -> torch.Tensor:
    """Per-image counts of the blocks that finished their sums (two-pass and
    grid bodies) and of those past the meeting point (grid body). The last
    block of an image sets its counts back to 0, so the buffer is zeroed
    once a process. One buffer a device: launches must not overlap on two
    streams (the port launches on one)."""
    buf = _counters.get(device)
    if buf is None or buf.numel() < B:
        buf = torch.zeros(max(B, 64), dtype=torch.int32, device=device)
        _counters[device] = buf
    return buf


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
    if not x.is_contiguous():
        fused_group_norm.copies += 1
        x = x.contiguous()
    S = H * W
    y = torch.empty_like(x)
    plan = groupnorm_plan(x.dtype, B, S, C, groups, weight.dtype,
                          _align(x.data_ptr(), y.data_ptr()))
    if plan.body == "two_pass":
        partial = torch.empty((B, -(-S // plan.rows_per_cta), 2, C),
                              dtype=torch.float32, device=x.device)
        scale_shift = torch.empty((2, B, C), dtype=torch.float32,
                                  device=x.device)
        scratch = (partial.data_ptr(), scale_shift.data_ptr(),
                   _counter(x.device, B).data_ptr())
    elif plan.body == "grid":
        partial = torch.empty((plan.blocks, 2, C), dtype=torch.float32,
                              device=x.device)
        scratch = (partial.data_ptr(), None,
                   _counter(x.device, 2 * B).data_ptr())
    else:
        scratch = (None, None, None)
    lib = build.load("groupnorm")
    fn = lib.ed_group_norm
    if not fn.argtypes:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int]
                       + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                       + [ctypes.c_float] + [ctypes.c_int] * 9
                       + [ctypes.c_void_p])
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = fn(x.data_ptr(), weight.data_ptr(), bias.data_ptr(), w_bf16,
                  y.data_ptr(), *scratch, B, S, C, groups, float(eps),
                  int(silu), _DTYPES[x.dtype], plan.code, plan.vec,
                  plan.cluster, plan.span, plan.rows_per_cta, plan.smem_bytes,
                  plan.blocks, stream)
    build.check(lib, code, "fused_group_norm")
    fused_group_norm.launches += 1
    note_launch("fused_group_norm", str(x.dtype), str(weight.dtype),
                float(eps), B, H, W, C, bool(silu))
    return y


fused_group_norm.launches = 0
fused_group_norm.copies = 0  # inputs that x.contiguous() had to copy


def _rows(x: torch.Tensor, what: str):
    """(B, S, C) of a (B, H, W, C) operand of the halves, S = H * W."""
    if not x.is_cuda:
        raise RuntimeError(f"{what} launches a CUDA kernel and needs CUDA "
                           "tensors")
    if x.dtype not in _DTYPES:
        raise TypeError(f"{what} takes bf16 or fp32, got {x.dtype}")
    if x.dim() != 4:
        raise ValueError(f"{what} takes (B, H, W, C), got {tuple(x.shape)}")
    B, H, W, C = x.shape
    return B, H * W, C


def group_norm_sums(x: torch.Tensor) -> torch.Tensor:
    """The statistics half alone: (B, 2, C) fp32 per-channel sum and sum
    of squares of a (B, H, W, C) bf16 or fp32 tensor on the GPU (a whole
    tensor or a window of rows of one). The two-pass body's ``gn_stats``:
    partial sums over row chunks, added in chunk order by the last block
    of each image; no atomics."""
    B, S, C = _rows(x, "group_norm_sums")
    if not x.is_contiguous():
        fused_group_norm.copies += 1
        x = x.contiguous()
    elt = x.element_size()
    plan = _two_pass_plan(elt, B, S, C, 0, _align(x.data_ptr()))
    sums = torch.empty((B, 2, C), dtype=torch.float32, device=x.device)
    partial = torch.empty((B, -(-S // plan.rows_per_cta), 2, C),
                          dtype=torch.float32, device=x.device)
    lib = build.load("groupnorm")
    fn = lib.ed_group_norm_sums
    if not fn.argtypes:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
                       + [ctypes.c_void_p])
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = fn(x.data_ptr(), sums.data_ptr(), partial.data_ptr(),
                  _counter(x.device, B).data_ptr(), B, S, C, _DTYPES[x.dtype],
                  plan.vec, plan.rows_per_cta, plan.smem_bytes, plan.blocks,
                  stream)
    build.check(lib, code, "group_norm_sums")
    group_norm_sums.launches += 1
    note_launch("group_norm_sums", str(x.dtype), *x.shape)
    return sums


group_norm_sums.launches = 0


def group_norm_apply(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
                     silu: bool = False) -> torch.Tensor:
    """The apply half alone: ``x * scale + shift`` (then SiLU) for a
    (B, H, W, C) bf16 or fp32 tensor on the GPU and (B, C) fp32 scale and
    shift; returns ``x.dtype``. The two-pass body's ``gn_apply``."""
    B, S, C = _rows(x, "group_norm_apply")
    if scale.dtype != torch.float32 or shift.dtype != torch.float32:
        raise TypeError("group_norm_apply takes fp32 scale and shift")
    if scale.shape != (B, C) or shift.shape != (B, C):
        raise ValueError(f"scale and shift must be {(B, C)}, got "
                         f"{tuple(scale.shape)} and {tuple(shift.shape)}")
    if not (scale.is_cuda and shift.is_cuda):
        raise RuntimeError("group_norm_apply needs CUDA tensors")
    if not x.is_contiguous():
        fused_group_norm.copies += 1
        x = x.contiguous()
    scale, shift = scale.contiguous(), shift.contiguous()
    y = torch.empty_like(x)
    elt = x.element_size()
    vec = 16 if (C * elt % 16 == 0
                 and _align(x.data_ptr(), y.data_ptr()) >= 16) else elt
    lib = build.load("groupnorm")
    fn = lib.ed_group_norm_apply
    if not fn.argtypes:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = fn(x.data_ptr(), scale.data_ptr(), shift.data_ptr(), y.data_ptr(),
                  B, S, C, int(silu), _DTYPES[x.dtype], vec, stream)
    build.check(lib, code, "group_norm_apply")
    group_norm_apply.launches += 1
    note_launch("group_norm_apply", str(x.dtype), str(scale.dtype), *x.shape,
                bool(silu))
    return y


group_norm_apply.launches = 0


def max_active_clusters(plan: GroupNormPlan, dtype: torch.dtype) -> int:
    """How many clusters of a cluster-body plan the card can hold at once
    (``cudaOccupancyMaxActiveClusters``); 0 would mean the plan cannot be
    scheduled."""
    if plan.body != "cluster":
        raise ValueError("only the cluster body launches clusters")
    lib = build.load("groupnorm")
    fn = lib.ed_group_norm_max_clusters
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * 3
    n = fn(_DTYPES[dtype], plan.cluster, plan.smem_bytes)
    if n < 0:
        build.check(lib, -n, "max_active_clusters")
    return n


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


def moment_sums(x: torch.Tensor, use_kernels: str = "auto") -> torch.Tensor:
    """Dispatch of the statistics half: ``group_norm_sums`` for a CUDA
    tensor, its plain version for a CPU tensor or under
    ``use_kernels='off'``."""
    if wants_kernel(use_kernels, x.is_cuda, "group_norm_sums"):
        return group_norm_sums(x)
    if x.is_cuda:
        group_norm.plain_cuda_calls += 1
    return reference_group_norm_sums(x)


def scale_shift(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
                silu: bool = False, use_kernels: str = "auto") -> torch.Tensor:
    """Dispatch of the apply half, as ``moment_sums``."""
    if wants_kernel(use_kernels, x.is_cuda, "group_norm_apply"):
        return group_norm_apply(x, scale, shift, silu)
    if x.is_cuda:
        group_norm.plain_cuda_calls += 1
    return reference_group_norm_apply(x, scale, shift, silu)
