"""The attention wrapper's choice of body and tile, and its plain version at
ragged key counts.

``attention_plan`` is a pure function of (dtype, B, Sq, Sk, H, D): which body
of ``csrc/flash_attention.cu`` a launch runs (``wgmma``, ``mma.sync`` or
``fma``), with which tile, how many blocks and how much shared memory. The
kernel itself runs only on the GPU; what surrounds it is checked here.
"""

import math
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elasticdiffusion_tpu.kernels.attention import (
    reference_attention as j_reference_attention)

from elasticdiffusion_tpu_torch.kernels import attention as tattn
from elasticdiffusion_tpu_torch.kernels import build
from elasticdiffusion_tpu_torch.kernels.flash_attention import (
    HEAD_DIMS, SM_COUNT, SMEM_PER_BLOCK, WGMMA_HEAD_DIMS, attention_plan,
    flash_attention, reference_attention)
from torch_port_common import max_abs, t2n

BF16, F32 = torch.bfloat16, torch.float32


def _body(dtype, D):
    if dtype == F32:
        return "fma"
    return "wgmma" if D in WGMMA_HEAD_DIMS else "mma.sync"


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
    assert plan.blocks == B * H * math.ceil(Sq / plan.bm)
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
    else:
        assert plan.code == 0


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
    # the acceptance of the design, readable in the source
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
