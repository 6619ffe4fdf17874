"""The LayerNorm wrapper's choice of body, and its plain version against the
JAX package's Pallas kernel at the widths of the paths.

``layernorm_plan`` is a pure function of (C, dtype, alignment): the body of
``csrc/layernorm.cu`` a launch runs, ``rows`` for a width instantiated for
itself (the UNet transformer blocks and the text encoders: 320, 640, 768,
1024, 1280 channels), ``any`` for every other width. The kernel runs only on
the GPU; here its plan is held to the source's instantiations, and its plain
version to the JAX kernel in interpret mode.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elasticdiffusion_tpu.kernels.layernorm import (
    fused_layer_norm as j_fused_layer_norm)

from elasticdiffusion_tpu_torch.kernels import build
from elasticdiffusion_tpu_torch.kernels import layernorm as tln
from elasticdiffusion_tpu_torch.kernels.layernorm import (
    ROWS_WIDTHS, fused_layer_norm, layernorm_plan, reference_layer_norm)
from torch_port_common import max_abs, t2n

BF16, F32 = torch.bfloat16, torch.float32
# the widths of every LayerNorm the three paths launch: SD 1.x / 2.x UNet
# (320, 640, 1280), SDXL UNet (640, 1280), CLIP L, OpenCLIP H, bigG (768,
# 1024, 1280)
PATH_WIDTHS = (320, 640, 768, 1024, 1280)


def _instantiations():
    """{C: (lanes a row in bf16, in fp32)} of ``ED_LN_ROWS`` in the source."""
    src = (build.CSRC / "layernorm.cu").read_text()
    return {int(c): (int(a), int(b)) for c, a, b in re.findall(
        r"^\s*ED_LN_ROWS\((\d+), (\d+), (\d+)\)", src, re.M)}


def test_every_path_width_has_an_instantiation():
    built = _instantiations()
    assert set(PATH_WIDTHS) <= set(built)
    assert built == ROWS_WIDTHS


@pytest.mark.parametrize("dtype", [BF16, F32])
@pytest.mark.parametrize("C", PATH_WIDTHS)
def test_plan_of_a_path_width_names_its_instantiation(C, dtype):
    plan = layernorm_plan(C, dtype)
    assert plan.body == "rows" and plan.code == 1
    lanes = _instantiations()[C][0 if dtype == BF16 else 1]
    assert plan.lanes_per_row == lanes and 32 % lanes == 0
    # every lane holds the same whole number of 16-byte chunks of the row
    vec = 16 // torch.tensor([], dtype=dtype).element_size()
    assert plan.chunks_per_lane * lanes * vec == C
    assert plan.threads % 32 == 0 and plan.threads % lanes == 0


@pytest.mark.parametrize("C", [40, 128, 256, 512, 2048, 1000])
def test_other_widths_take_the_generic_body(C):
    for dtype in (BF16, F32):
        plan = layernorm_plan(C, dtype)
        assert plan.body == "any" and plan.code == 0


def test_unaligned_rows_take_the_generic_body_and_unknown_dtypes_raise():
    assert layernorm_plan(640, BF16, aligned=False).body == "any"
    with pytest.raises(NotImplementedError):
        layernorm_plan(640, torch.float16)


@pytest.mark.parametrize("dtype", [BF16, F32])
@pytest.mark.parametrize("C", PATH_WIDTHS)
def test_plain_version_matches_jax_kernel_at_path_widths(C, dtype):
    """16 rows; the same numpy inputs, cast to the working dtype on both
    sides, fp32 weight and bias; the JAX Pallas kernel in interpret mode.
    A CPU tensor takes the plain version and counts no launch."""
    rng = np.random.default_rng(C)
    x = (rng.standard_normal((16, C)) * 1.5 + 0.3).astype(np.float32)
    w = (1 + 0.1 * rng.standard_normal(C)).astype(np.float32)
    b = (0.1 * rng.standard_normal(C)).astype(np.float32)
    jdt = jnp.float32 if dtype == F32 else jnp.bfloat16
    want = np.asarray(j_fused_layer_norm(
        jnp.asarray(x).astype(jdt), jnp.asarray(w), jnp.asarray(b), eps=1e-5,
        interpret=True).astype(jnp.float32))
    tx = torch.from_numpy(x).to(dtype)
    before = fused_layer_norm.launches
    got = tln.layer_norm(tx, torch.from_numpy(w), torch.from_numpy(b), 1e-5)
    assert fused_layer_norm.launches == before
    assert got.dtype == dtype
    assert torch.equal(got, reference_layer_norm(
        tx, torch.from_numpy(w), torch.from_numpy(b), 1e-5))
    got = t2n(got.float())
    if dtype == F32:
        # fp32 statistics on both sides, sums in another order
        assert max_abs(got, want) < 1e-5
    else:
        # both sides round the same fp32 result to bf16; sums in another
        # order may put them one bf16 ulp apart at the largest magnitude
        top = np.abs(want).max()
        assert max_abs(got, want) <= 2.0 ** (np.floor(np.log2(top)) - 7)
