"""The conv kernel wrapper's choice of body, tile and K splits, and the plain
version of its split-K sum.

``conv_plan`` is a pure function of (dtype, B, H, W, C, O): which body of
``csrc/conv3x3.cu`` a launch runs (``wgmma`` for bf16, ``fma`` for fp32),
with which pixel tile, how many output channels a tile, how many work items
share one tile's K loop, and how much shared memory. The kernel itself runs only
on the GPU; what surrounds it is checked here.
"""

import math
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elasticdiffusion_tpu.kernels.conv3x3 import (
    reference_conv3x3 as j_reference_conv3x3)

from elasticdiffusion_tpu_torch.kernels import build
from elasticdiffusion_tpu_torch.kernels.conv3x3 import (
    MAX_SPLITS, SM_COUNT, SMEM_PER_BLOCK, WGMMA_TILES, conv_plan,
    reference_conv3x3, split_k_conv3x3, split_ranges, wgmma_plan)
from torch_port_common import max_abs, t2n

BF16, F32 = torch.bfloat16, torch.float32

# (latent side, C, O) of every gated 3x3 conv of the UNets, and the batches
# the requests give them (8 resampled direction forwards, 2 cond/uncond, 3
# and 9 views)
SDXL = ((128, 320, 320), (128, 960, 320), (128, 640, 320), (64, 320, 640),
        (64, 640, 640), (64, 1920, 640), (64, 1280, 640), (64, 960, 640),
        (32, 640, 1280), (32, 1280, 1280), (32, 2560, 1280), (32, 1920, 1280),
        (64, 1280, 1280), (128, 640, 640))
SD15 = ((64, 320, 320), (32, 640, 640), (16, 1280, 1280), (8, 1280, 1280),
        (16, 2560, 1280), (8, 2560, 1280), (16, 640, 1280), (16, 1920, 1280),
        (32, 320, 640), (32, 1920, 640), (32, 1280, 640), (32, 960, 640),
        (64, 960, 320), (64, 640, 320))
PATH_SHAPES = ([(B, S, C, O) for S, C, O in SDXL for B in (8, 2, 3, 9)]
               + [(B, S, C, O) for S, C, O in SD15 for B in (8, 2, 3)])


def _tiles(plan, B, H, W, O):
    tw, th, tb = plan.tile
    return (math.ceil(W / tw) * math.ceil(H / th) * math.ceil(B / tb)
            * math.ceil(O / plan.bn))


@pytest.mark.parametrize("B,S,C,O", PATH_SHAPES)
def test_plan_of_every_path_shape(B, S, C, O):
    plan = conv_plan(BF16, B, S, S, C, O)
    assert plan.body == "wgmma" and plan.code in WGMMA_TILES
    bn, stages, mt = WGMMA_TILES[plan.code]
    assert (plan.bn, plan.stages) == (bn, stages)
    assert plan.smem_bytes <= SMEM_PER_BLOCK == 232448
    assert plan.threads == 384  # two consumer warpgroups and a producer
    # 128 or 256 pixels a tile, and no masked row or column at the latents
    tw, th, tb = plan.tile
    assert tw * th * tb == 128 * mt
    assert S % tw == 0 and S % th == 0
    tiles = _tiles(plan, B, S, S, O)
    assert plan.items == tiles * plan.splits
    assert plan.blocks == min(plan.items, SM_COUNT)  # persistent grid
    # K splits exactly where the tiles alone cannot fill the card
    assert (plan.splits > 1) == (tiles < SM_COUNT)
    assert plan.splits <= min(MAX_SPLITS, math.ceil(C / 64))


@pytest.mark.parametrize("B,H,W,C,O", [
    (2, 42, 61, 328, 72),     # ragged H, W, C and O
    (8, 96, 96, 320, 320),
    (3, 5, 7, 200, 136),      # image smaller than a tile
    (1, 8, 8, 64, 8),         # one chunk: nothing to split
    (2, 24, 40, 48, 64),      # C < 64: TMA zero-fills the rest of the box
    (1, 3, 3, 8, 8),
])
def test_ragged_and_small_c_shapes_get_a_plan(B, H, W, C, O):
    plan = conv_plan(BF16, B, H, W, C, O)
    assert plan.body == "wgmma" and plan.smem_bytes <= SMEM_PER_BLOCK
    assert plan.splits >= 1 and plan.blocks >= 1
    assert plan.items == _tiles(plan, B, H, W, O) * plan.splits
    assert plan.blocks == min(plan.items, SM_COUNT)
    assert plan.splits <= max(1, math.ceil(C / 64))


def test_fp32_keeps_the_fma_body_and_unbuilt_shapes_raise():
    plan = conv_plan(F32, 2, 64, 64, 320, 320)
    assert (plan.body, plan.code, plan.splits) == ("mma.tf32x3", 0, 1)
    with pytest.raises(NotImplementedError):
        conv_plan(torch.float16, 1, 8, 8, 64, 64)
    with pytest.raises(ValueError):
        conv_plan(BF16, 1, 8, 8, 60, 64)


def test_plans_name_instantiations_of_the_source():
    """The tiles the wrapper plans are the ones the C entry instantiates,
    and the design is readable in the source."""
    src = (build.CSRC / "conv3x3.cu").read_text()
    built = {int(c): (int(bn), int(st), int(mt)) for c, bn, st, mt in re.findall(
        r"plan == (\d)\) return \(int\)launch_wgmma<(\d+), (\d+), (\d)>",
        src)}
    assert built == WGMMA_TILES
    assert '#include "sm90.cuh"' in src
    src += (build.CSRC / "sm90.cuh").read_text()
    for needle in ("wgmma.mma_async", "cp.async.bulk.tensor.4d",
                   "mbarrier.try_wait", "setmaxnreg", "conv3x3_splitk_sum"):
        assert needle in src


@pytest.mark.parametrize("kiters,splits", [(9, 1), (54, 2), (180, 4), (27, 5)])
def test_split_ranges_cover_the_k_loop(kiters, splits):
    ranges = split_ranges(kiters, splits)
    assert ranges[0][0] == 0 and ranges[-1][1] == kiters
    assert all(lo < hi == nxt for (lo, hi), (nxt, _) in zip(ranges, ranges[1:]))


@pytest.fixture(scope="module")
def conv_case():
    """fp32 operands with C = 136 (three 64-channel chunks, the last
    ragged: 27 K iterations), and the JAX package's reference on them."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 6, 5, 136)).astype(np.float32)
    w = (rng.standard_normal((3, 3, 136, 24)) * 0.05).astype(np.float32)
    b = (rng.standard_normal((24,)) * 0.1).astype(np.float32)
    want = np.asarray(j_reference_conv3x3(jnp.asarray(x), jnp.asarray(w),
                                          jnp.asarray(b), silu_out=True))
    return x, w, b, want


@pytest.mark.parametrize("splits", [1, 2, 3, 5])
def test_split_k_sum_matches_jax_reference(conv_case, splits):
    """The plain version of the split-K path: fp32 partial sums over the
    kernel's K ranges, added in split order, then bias and SiLU."""
    x, w, b, want = conv_case
    tx, tw, tb = (torch.from_numpy(a) for a in (x, w, b))
    got = split_k_conv3x3(tx, tw, tb, silu_out=True, splits=splits)
    assert got.dtype == F32 and tuple(got.shape) == want.shape
    # fp32 on both sides; the sums over 9*C products run in another order
    assert max_abs(t2n(got), want) < 1e-5
    assert max_abs(t2n(got), t2n(reference_conv3x3(tx, tw, tb, True))) < 1e-5


def test_split_k_sum_at_the_planned_split_of_a_small_grid(conv_case):
    """A shape small enough to be split gets its plan's split count, and the
    plain version of that split agrees with the unsplit reference."""
    x, w, b, _ = conv_case
    plan = conv_plan(BF16, *x.shape, w.shape[-1])
    assert plan.splits == 3  # one 2x6x5 tile, three channel chunks
    tx, tw, tb = (torch.from_numpy(a).to(BF16) for a in (x, w, b))
    got = split_k_conv3x3(tx, tw, tb, splits=plan.splits)
    want = reference_conv3x3(tx, tw, tb)
    assert got.dtype == BF16
    # one rounding to bf16 on both sides of fp32 sums in another order
    top = want.float().abs().max().item()
    assert max_abs(t2n(got.float()), t2n(want.float())) <= 2.0 ** -7 * top
