"""The attention wrapper's choice of body and tile, and its plain version at
ragged key counts.

``attention_plan`` is a pure function of (dtype, B, Sq, Sk, H, D): which body
of ``csrc/flash_attention.cu`` a launch runs (``wgmma``, ``wgmma.d512``,
``fma.tiled`` or ``fma``), with which tile, how many blocks, how much shared
memory and, for the bodies at head dim 512, over how many blocks the keys
are split. The kernel itself runs only on the GPU; what surrounds it is
checked here, with the plain version of the split-key merge.
"""

import math
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elasticdiffusion_tpu.kernels import flash_attention as jfa
from elasticdiffusion_tpu.kernels.attention import (
    reference_attention as j_reference_attention)

from elasticdiffusion_tpu_torch.kernels import attention as tattn
from elasticdiffusion_tpu_torch.kernels import build
from elasticdiffusion_tpu_torch.kernels.flash_attention import (
    F512_SMEM, HEAD_DIMS, MAX_KEY_SPLITS, SM_COUNT, SMEM_PER_BLOCK,
    W512_SMEM, WGMMA_HEAD_DIMS, attention_plan, flash_attention,
    key_split_ranges, key_splits, reference_attention, split_key_attention)
from torch_port_common import max_abs, t2n

BF16, F32 = torch.bfloat16, torch.float32


def _body(dtype, D):
    if dtype == F32:
        return "fma.tiled" if D == 512 else "mma.tf32x3"
    return "wgmma" if D in WGMMA_HEAD_DIMS else "wgmma.d512"


def _main_path_shapes():
    """(dtype, B, Sq, Sk, H, D) of every attention launch of the three full-
    width paths: the UNet blocks of SD 2.1, SDXL and SD 1.5 at the batch
    sizes the requests give (8 resampled direction forwards, 2 cond/uncond,
    3 and 9 views) and at batch 1, self and on the 77 text tokens, and the
    VAE mid blocks."""
    shapes = []
    for S, H, D in ((4096, 5, 64), (1024, 10, 64), (256, 20, 64),
                    (4096, 10, 64), (1024, 20, 64),
                    (4096, 8, 40), (1024, 8, 80), (256, 8, 160)):
        for B in (8, 1, 2, 3, 9):
            shapes.append((BF16, B, S, S, H, D))
            shapes.append((BF16, B, S, 77, H, D))
    for S in (6144, 9216):
        shapes.append((BF16, 1, S, S, 1, 512))
    for S in (704, 2688, 2816, 4096, 24576, 36864):
        shapes.append((F32, 1, S, S, 1, 512))
    return shapes


@pytest.mark.parametrize("dtype,B,Sq,Sk,H,D", _main_path_shapes())
def test_plan_of_every_main_path_shape(dtype, B, Sq, Sk, H, D):
    plan = attention_plan(dtype, B, Sq, Sk, H, D)
    assert plan.body == _body(dtype, D)
    assert plan.blocks == B * H * math.ceil(Sq / plan.bm) * plan.splits
    # the grid fills the card, or the block is the small one
    assert plan.blocks >= SM_COUNT or plan.bm <= 64
    assert plan.smem_bytes <= SMEM_PER_BLOCK == 232448
    assert plan.threads <= 1024 and plan.threads % 32 == 0
    if plan.body == "wgmma":
        assert plan.code in (1, 2, 3)
        # consumer warpgroups of 64 rows and one producer warpgroup
        assert plan.threads == 128 * (plan.bm // 64 + 1)
        if Sk <= 80:       # the text tokens: one tile holds every key
            assert (plan.bn, plan.stages) == (80, 1) and plan.bm == 64
        else:              # a ring of at least 2 stages
            assert plan.stages >= 2 and plan.bn in (64, 128)
        assert plan.bn % 8 == 0 and (plan.bn * 128) % 1024 == 0
    elif plan.body == "fma.tiled":
        assert (plan.code, plan.bm, plan.bn, plan.threads) == (4, 64, 64, 256)
        assert 1 <= plan.splits <= math.ceil(Sk / plan.bn)
    elif plan.body == "wgmma.d512":
        # two consumer warpgroups (one half of the head dim each) and a
        # producer; 32-key tiles
        assert (plan.code, plan.bm, plan.bn, plan.threads) == (5, 64, 32, 384)
        assert 1 <= plan.splits <= math.ceil(Sk / plan.bn)
    else:
        assert plan.code == 0 and plan.splits == 1


@pytest.mark.parametrize("dtype", [BF16, F32])
@pytest.mark.parametrize("D", HEAD_DIMS)
def test_every_built_head_dim_has_a_body(dtype, D):
    for Sk in (77, 1024):
        plan = attention_plan(dtype, 2, 1024, Sk, 8, D)
        assert plan.body == _body(dtype, D)
        assert plan.smem_bytes <= SMEM_PER_BLOCK


def test_unbuilt_head_dim_or_dtype_has_no_plan():
    with pytest.raises(NotImplementedError):
        attention_plan(BF16, 1, 256, 256, 1, 48)
    with pytest.raises(NotImplementedError):
        attention_plan(torch.float16, 1, 256, 256, 1, 64)


def test_wgmma_plans_name_instantiations_of_the_source():
    """The tiles the wrapper plans are the ones the C entry instantiates."""
    src = (build.CSRC / "flash_attention.cu").read_text()
    built = dict(re.findall(
        r"plan == (\d)\) return \(int\)launch_wgmma<DD, (\d, \w+, \w+)>", src))
    assert built == {"1": "2, BN1, ST1", "2": "1, 64, ST2", "3": "1, 80, 1"}
    for D in WGMMA_HEAD_DIMS:
        macro = re.search(rf"ED_FLASH_WGMMA\({D}, (\d+), (\d), (\d)\)", src)
        assert macro, f"head dim {D} is not instantiated"
        bn1, stages1, stages2 = map(int, macro.groups())
        want = {1: (2, bn1, stages1), 2: (1, 64, stages2), 3: (1, 80, 1)}
        for shape in ((8, 4096, 4096, 10), (1, 256, 256, 20), (8, 4096, 77, 10)):
            B, Sq, Sk, H = shape
            plan = attention_plan(BF16, B, Sq, Sk, H, D)
            assert want[plan.code] == (plan.bm // 64, plan.bn, plan.stages)
    assert {attention_plan(BF16, *s, 64).code for s in (
        (8, 4096, 4096, 10), (1, 256, 256, 20), (8, 4096, 77, 10))} == {1, 2, 3}
    # the acceptance of the design, readable in the source and the Hopper
    # building blocks it includes
    assert '#include "sm90.cuh"' in src
    src += (build.CSRC / "sm90.cuh").read_text()
    for needle in ("wgmma.mma_async", "cp.async.bulk.tensor", "mbarrier.try_wait",
                   "setmaxnreg"):
        assert needle in src


def _bf16_ulp(x: float) -> float:
    return 2.0 ** (math.floor(math.log2(max(abs(x), 1e-30))) - 7)


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("Sk", [77, 200])
def test_plain_version_at_ragged_keys_matches_jax_and_counts_no_launch(Sk, dtype):
    """A CPU tensor inside the gate takes the plain version, counts no
    launch, and gives the JAX reference's numbers at key counts that are no
    multiple of any tile."""
    rng = np.random.default_rng(Sk)
    q, k, v = (rng.standard_normal((1, 256, 2, 64)).astype(np.float32),
               rng.standard_normal((1, Sk, 2, 64)).astype(np.float32),
               rng.standard_normal((1, Sk, 2, 64)).astype(np.float32))
    tq, tk, tv = (torch.from_numpy(a).to(dtype) for a in (q, k, v))
    jdt = jnp.float32 if dtype == F32 else jnp.bfloat16
    want = np.asarray(j_reference_attention(
        *(jnp.asarray(a).astype(jdt) for a in (q, k, v))).astype(jnp.float32))
    assert tattn.in_gate(tq, causal=False)
    before = flash_attention.launches
    got = tattn.dot_product_attention(tq, tk, tv)
    assert flash_attention.launches == before
    assert got.dtype == dtype and tuple(got.shape) == (1, 256, 2, 64)
    direct = reference_attention(tq, tk, tv)
    assert torch.equal(got, direct)
    if dtype == F32:
        assert max_abs(t2n(got), want) < 1e-5
    else:
        # both sides round fp32 results to bf16: one ulp at the largest value
        assert max_abs(t2n(got.float()), want) <= _bf16_ulp(np.abs(want).max())


# (Sq = Sk, key splits) of the fp32 head-dim-512 attentions of the paths: the
# strip encodes (704, 2688, 2816 tokens), a 512x512 decode (4096) and the
# SDXL fp32 decodes (24576, 36864)
F32_PATH_SPLITS = ((704, 11), (2688, 3), (2816, 3), (4096, 2), (24576, 1),
                   (36864, 2))


@pytest.mark.parametrize("S,splits", F32_PATH_SPLITS)
def test_fp32_d512_split_rule_at_path_shapes(S, splits):
    plan = attention_plan(F32, 1, S, S, 1, 512)
    assert plan.body == "fma.tiled" and plan.stages == 2
    row_blocks = math.ceil(S / 64)
    assert plan.splits == splits == key_splits(row_blocks, math.ceil(S / 64))
    # the query rows alone leave SMs idle where the keys are split; the
    # 36864-token decode is split too, because its fifth wave of 64-row
    # blocks would be a third full
    assert (plan.splits > 1) == (row_blocks < SM_COUNT or S == 36864)
    assert plan.blocks == row_blocks * plan.splits
    assert plan.smem_bytes == F512_SMEM <= SMEM_PER_BLOCK


@pytest.mark.parametrize("row_blocks", [1, 5, 11, 42, 64, 100, 131, 132, 384,
                                        576, 2000])
@pytest.mark.parametrize("key_tiles", [1, 2, 11, 42, 576])
def test_key_splits_stay_in_range(row_blocks, key_tiles):
    s = key_splits(row_blocks, key_tiles)
    assert 1 <= s <= max(1, min(key_tiles, MAX_KEY_SPLITS))
    if row_blocks < SM_COUNT and key_tiles >= 2:
        assert s >= 2


@pytest.mark.parametrize("Sk,splits", [(64, 1), (300, 2), (300, 5), (704, 11),
                                       (130, 3)])
def test_key_split_ranges_cover_the_keys_in_whole_tiles(Sk, splits):
    ranges = key_split_ranges(Sk, splits)
    assert len(ranges) == splits and ranges[0][0] == 0 and ranges[-1][1] == Sk
    for (lo, hi), (nxt, _) in zip(ranges, ranges[1:]):
        assert lo < hi == nxt and lo % 64 == 0


@pytest.fixture(scope="module")
def split_case():
    """fp32 operands at head dim 512, keys in 5 tiles (the last ragged),
    and the JAX package's reference attention on them."""
    rng = np.random.default_rng(512)
    q, k, v = (rng.standard_normal((1, S, 2, 512)).astype(np.float32)
               for S in (96, 300, 300))
    want = np.asarray(j_reference_attention(*(jnp.asarray(a) for a in (q, k, v))))
    return q, k, v, want


@pytest.mark.parametrize("splits", [1, 2, 3, 4, 5])
def test_split_key_merge_matches_jax_reference(split_case, splits):
    """The plain version of the fp32 bodies' split-key path: per-split (m,
    l, O) merged in split order gives the JAX reference's numbers."""
    q, k, v, want = split_case
    got = split_key_attention(*(torch.from_numpy(a) for a in (q, k, v)), splits)
    assert got.dtype == F32 and tuple(got.shape) == want.shape
    # fp32 sums in another order, and exp against the merge's rescaling
    assert max_abs(t2n(got), want) < 1e-5
    ref = reference_attention(*(torch.from_numpy(a) for a in (q, k, v)))
    assert max_abs(t2n(got), t2n(ref)) < 1e-5


# (Sq = Sk, key splits) of the bf16 head-dim-512 attentions of the paths:
# the VAE mid blocks of the SD 1.x / 2.x decodes at 512x768 and 768x768 px
BF16_PATH_SPLITS = ((6144, 4), (9216, 6))


@pytest.mark.parametrize("S,splits", BF16_PATH_SPLITS)
def test_bf16_d512_plan_at_path_shapes(S, splits):
    plan = attention_plan(BF16, 1, S, S, 1, 512)
    assert plan.body == "wgmma.d512" and plan.code == 5
    # two consumer warpgroups and one producer warpgroup
    assert plan.threads == 384 and (plan.bm, plan.bn, plan.stages) == (64, 32, 2)
    row_blocks = math.ceil(S / 64)
    assert row_blocks < SM_COUNT or S == 9216  # why the keys are split
    assert plan.splits == splits == key_splits(row_blocks, math.ceil(S / 64))
    assert plan.blocks == row_blocks * plan.splits
    # Q, two K and two V slots of 32 keys, the S exchange, slack, barriers
    assert plan.smem_bytes == W512_SMEM == (
        1024 + 64 * 512 * 2 + 4 * 32 * 512 * 2 + 2 * 2 * 16 * 128 * 4 + 128)
    assert plan.smem_bytes <= SMEM_PER_BLOCK


def test_bf16_d512_plan_names_an_instantiation_of_the_source():
    """Plan 5 is the wgmma body at head dim 512 in the C entry, with the
    shared memory and threads of its configuration; no bf16 body is
    mma.sync (the fp32 body at the UNet head dims is: TF32 in three
    passes, which wgmma takes only from K-major shared memory)."""
    src = (build.CSRC / "flash_attention.cu").read_text()
    assert re.search(r"if \(plan == 5\) \{[^}]*launch_w512\(", src)
    cfg = re.search(r"struct W512Cfg \{(.*?)\n\};", src, re.S).group(1)
    assert "D = 512, BM = 64, BN = 32, THREADS = 384, SLOTS = 2" in cfg
    assert "flash_wgmma_bf16_d512" in src
    assert "flash_mma_bf16" not in src
    assert all("tf32" in line.lower() or "TF32" in line
               for line in src.splitlines() if "mma.sync" in line)
    plans = {attention_plan(dt, B, S, S, H, D).body
             for dt in (BF16, F32) for D in HEAD_DIMS
             for B, S, H in ((1, 6144, 1), (8, 1024, 8), (2, 77, 2))}
    assert "mma.sync" not in plans
    assert plans == {"wgmma", "wgmma.d512", "mma.tf32x3", "fma.tiled"}


@pytest.fixture(scope="module")
def bf16_split_case():
    """bf16 operands at head dim 512, 256 keys (8 tiles of 32), and the
    JAX package's reference attention and bf16 streaming kernel (interpret
    mode, 128-key blocks) on them."""
    rng = np.random.default_rng(1512)
    q, k, v = (rng.standard_normal((1, 256, 1, 512)).astype(np.float32)
               for _ in range(3))
    jq, jk, jv = (jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v))
    ref = np.asarray(j_reference_attention(jq, jk, jv).astype(jnp.float32))
    kernel = np.asarray(jfa.flash_attention(
        jq, jk, jv, block_q=128, block_k=128, interpret=True,
        oneshot="off").astype(jnp.float32))
    tq, tk, tv = (torch.from_numpy(a).bfloat16() for a in (q, k, v))
    return (tq, tk, tv), ref, kernel


@pytest.mark.parametrize("splits", [1, 2, 3, 4])
def test_bf16_split_key_merge_matches_jax(bf16_split_case, splits):
    """The plain version of the bf16 body's split-key path (P rounded to
    bf16 inside each split, l from the unrounded P, fp32 merge) against the
    JAX reference and the JAX bf16 streaming kernel."""
    (tq, tk, tv), ref, kernel = bf16_split_case
    got = split_key_attention(tq, tk, tv, splits, bn=32)
    assert got.dtype == BF16 and tuple(got.shape) == ref.shape
    got = t2n(got.float())
    # P is rounded to bf16 against other maxima on each side (per split
    # here, per 128-key block of the running max in the JAX kernel, the
    # global max in the reference), and each output is rounded to bf16: two
    # bf16 ulps at the largest output magnitude
    tol = 2 * _bf16_ulp(np.abs(ref).max())
    assert max_abs(got, ref) <= tol
    assert max_abs(got, kernel) <= tol
