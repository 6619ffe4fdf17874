"""The GroupNorm kernel's plan and the plain version of its order of sums.

``groupnorm_plan`` chooses the body of ``fused_group_norm`` (a cluster of
blocks a slab, or the whole grid, each one launch; or two passes for what
neither takes) and mirrors the instantiations of ``csrc/groupnorm.cu``; it
is checked at every shape the paths of ``chip_smoke.py`` launch. ``split_group_norm``, the
kernel's order of sums in plain torch (per-channel sums of each block's rows,
then over groups and blocks in the order of each body), is held to the JAX
package's
``reference_group_norm`` and to its Pallas kernel in interpret mode.

Tolerances: fp32 outputs within 1e-5 of the JAX package (the same
E[x^2] - E[x]^2 in fp32, sums in another order), those of
tests/test_torch_port_kernels.py; bf16 outputs within one bf16 step at the
largest magnitude, 2^-7 x max|out| (the fp32 results of the two sides, a few
fp32 ulps apart, may round to neighbouring bf16 values).
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from elasticdiffusion_tpu.kernels.groupnorm import (
    fused_group_norm as j_fused_group_norm,
    reference_group_norm as j_reference_group_norm)
from elasticdiffusion_tpu_torch import configs as tcfg
from elasticdiffusion_tpu_torch.kernels import groupnorm as tgn
from elasticdiffusion_tpu_torch.models.layers import GroupNorm32

CU = (Path(tgn.__file__).parent / "csrc" / "groupnorm.cu").read_text()
CASES = chip_smoke.groupnorm_cases()
UNET_TAGS = ("sdxl", "sd15", "sd21")


def _case_id(case):
    tag, dtype, w_dtype, eps, B, H, W, C, silu, _ = case
    return f"{tag}_{str(dtype)[6:]}_{B}x{H}x{W}x{C}" + ("_silu" if silu else "")


@pytest.mark.parametrize("case", CASES, ids=[_case_id(c) for c in CASES])
def test_plan_at_every_path_shape(case):
    tag, dtype, w_dtype, eps, B, H, W, C, silu, _ = case
    S, G = H * W, 32
    plan = tgn.groupnorm_plan(dtype, B, S, C, G, w_dtype)
    elt = 2 if dtype == torch.bfloat16 else 4
    gs = C // G
    # spans are whole groups and whole chunks of the plan's width
    assert plan.span % gs == 0 and C % plan.span == 0
    assert plan.span * elt % plan.vec == 0
    assert plan.cluster in tgn.CLUSTERS
    if plan.body == "cluster":
        assert plan.code == 1 and plan.vec == 16
        # of the cluster sizes that fit, the one the model rates fastest
        units = B * (C // plan.span)
        fitting = {}
        for c in tgn.CLUSTERS:
            rows = -(-S // c)
            rows = -(-rows // tgn.BOX_ROWS) * tgn.BOX_ROWS
            smem = tgn._cluster_smem(rows, plan.span, elt, plan.span // gs)
            if c <= S and smem <= tgn.SMEM_MAX:
                fitting[c] = tgn._cluster_seconds(units, c, rows * plan.span * elt, smem)
        assert fitting[plan.cluster] == min(fitting.values())
        # the blocks of a cluster hold every row of the slab in whole TMA
        # boxes, and fit shared memory
        rows = -(-S // plan.cluster)
        assert plan.rows_per_cta % tgn.BOX_ROWS == 0
        rows = -(-rows // tgn.BOX_ROWS) * tgn.BOX_ROWS
        assert plan.rows_per_cta == rows and rows * plan.cluster >= S
        assert plan.rows_per_cta * plan.span * elt < plan.smem_bytes <= tgn.SMEM_MAX
        assert plan.smem_bytes <= 227 * 1024
        assert plan.blocks == B * (C // plan.span) * plan.cluster
        # a span is at most the width of a TMA box
        assert plan.span <= 256
        # and no span splits most of its 32-byte sectors with a neighbour
        assert plan.span * elt % 32 == 0 or plan.span * elt >= 64
        assert plan.span * elt % 16 == 0
    elif plan.body == "grid":
        assert plan.code == 3 and plan.cluster == 1 and plan.span == C
        assert plan.blocks <= tgn.SMS and plan.smem_bytes <= tgn.SMEM_MAX
    else:
        assert plan.code == 2 and plan.cluster == 1 and plan.span == C
        assert plan.smem_bytes <= tgn.SMEM_MAX
        assert plan.rows_per_cta * -(-S // plan.rows_per_cta) >= S
    # one launch at every shape of the paths
    assert plan.body in ("cluster", "grid")


@pytest.mark.parametrize("dtype,B,H,W,C", [
    (torch.float32, 1, 1536, 1536, 128),   # SDXL decoder, 37.7 MB a group
    (torch.bfloat16, 1, 512, 768, 128),    # SD 1.x / 2.x decoder, 3.1 MB
    (torch.float32, 1, 176, 1024, 128),    # SDXL strip encode, 2.9 MB
    (torch.bfloat16, 8, 128, 128, 960),    # SDXL up block, a cluster of 16
])
def test_slabs_too_large_for_a_cluster_take_the_grid_body(dtype, B, H, W, C):
    """One launch that reads the rows a block cannot keep twice: one block
    an SM, all resident at once, as many rows kept as fit."""
    plan = tgn.groupnorm_plan(dtype, B, H * W, C, 32, torch.float32)
    elt = 2 if dtype == torch.bfloat16 else 4
    assert plan.body == "grid" and plan.code == 3 and plan.vec == 16
    assert plan.blocks % B == 0 and plan.blocks <= tgn.SMS
    K = plan.blocks // B
    assert K * plan.rows_per_cta >= H * W > (K - 1) * plan.rows_per_cta
    assert plan.smem_bytes <= tgn.SMEM_MAX
    _, resident = tgn._grid_plan(dtype, B, H * W, C, 32)
    assert 0 < resident * C * elt < plan.smem_bytes


@pytest.mark.parametrize("dtype,B,H,W,C,G,align,body,vec", [
    (torch.bfloat16, 2, 12, 20, 72, 8, 16, "cluster", 16),  # 144-byte span
    (torch.bfloat16, 1, 96, 96, 8192, 32, 16, "two_pass", 16),  # 1024 chunks
    (torch.bfloat16, 2, 24, 24, 30, 1, 16, "two_pass", 2),  # 60-byte rows
    (torch.bfloat16, 2, 64, 64, 320, 32, 2, "two_pass", 2),  # unaligned
])
def test_plan_edges(dtype, B, H, W, C, G, align, body, vec):
    """The bodies and chunk widths no path shape reaches; chip_smoke.py
    holds each against its plain version (groupnorm_edge_cases)."""
    plan = tgn.groupnorm_plan(dtype, B, H * W, C, G, dtype, align)
    assert (plan.body, plan.vec) == (body, vec)


@pytest.mark.parametrize("align,body,vec", [(16, "cluster", 16),
                                            (8, "two_pass", 2),
                                            (4, "two_pass", 2)])
def test_plan_narrows_its_chunks_to_the_addresses(align, body, vec):
    """TMA and the grid body's 16-byte loads need 16-byte aligned rows."""
    plan = tgn.groupnorm_plan(torch.bfloat16, 2, 32 * 32, 1280, 32,
                              torch.bfloat16, align)
    assert (plan.body, plan.vec) == (body, vec)


def test_plan_mirrors_the_source():
    """Constants and instantiations of csrc/groupnorm.cu: change both
    together."""
    for name, value in (("THREADS", tgn.THREADS), ("SMEM_MAX", tgn.SMEM_MAX),
                        ("UNROLL", tgn.UNROLL), ("BOX_ROWS", tgn.BOX_ROWS),
                        ("GRID_THREADS", tgn.GRID_THREADS)):
        assert re.search(rf"constexpr int {name} = {value};", CU), name
    assert re.search(r"constexpr int APPLY_BYTES = 32 \* 1024;", CU)
    assert tgn.APPLY_BYTES == 32 * 1024
    for T in ("bf16", "float"):
        assert f"launch_cluster<{T}>" in CU and f"max_clusters<{T}>" in CU
    for launch in ("ED_GN_TWO_PASS(bf16, 8)", "ED_GN_TWO_PASS(bf16, 1)",
                   "ED_GN_TWO_PASS(float, 4)", "ED_GN_TWO_PASS(float, 1)",
                   "launch_grid<bf16>", "launch_grid<float>"):
        assert launch in CU
    # the grid body's resident rows follow from its shared memory as in
    # _grid_plan, and its blocks are all resident at once
    assert "const int scratch = 4 * (TY * 2 * C + 2 * C + 2 * G) + 16;" in CU
    assert "cudaLaunchAttributeCooperative" in CU
    assert "cudaLaunchKernelEx" in CU and "cudaOccupancyMaxActiveClusters" in CU
    assert "cudaFuncAttributeNonPortableClusterSizeAllowed" in CU
    # the attributes once an instantiation, not at each launch
    assert re.search(r"static cudaError_t err = \[\] \{\n\s+cudaError_t e = cudaFuncSetAttribute", CU)


def test_cases_carry_the_models_weight_dtype_and_eps():
    """Each case has the eps and the weight dtype of the modules that launch
    its shape: UNet norms in the bf16 parameter dtype, ResNet norms (SiLU)
    at 1e-5 and Transformer2D norms at 1e-6; VAE norms fp32 at 1e-6."""
    from elasticdiffusion_tpu_torch.models.unet import UNet2DCondition
    from elasticdiffusion_tpu_torch.models.vae import AutoencoderKL
    with torch.device("meta"):
        unet = UNet2DCondition(tcfg.UNET_SDXL)
        vae = AutoencoderKL(tcfg.VAEConfig())
    norms = lambda m: {(n.silu, n.eps) for n in m.modules()
                       if isinstance(n, GroupNorm32)}
    unet_norms, vae_norms = norms(unet), norms(vae)
    assert unet_norms == {(True, 1e-5), (False, 1e-6)}
    assert vae_norms == {(True, 1e-6), (False, 1e-6)}
    param_dtype = tcfg.RuntimeConfig().param_dtype
    for tag, dtype, w_dtype, eps, B, H, W, C, silu, _ in CASES:
        if tag in UNET_TAGS:
            assert (silu, eps) in unet_norms and w_dtype == param_dtype
        else:
            assert (silu, eps) in vae_norms and w_dtype == torch.float32
    assert {(d, w) for t, d, w, *_ in CASES if t == "vae_decode"} == {
        (torch.bfloat16, torch.float32), (torch.float32, torch.float32)}
    for tag, dtype, w_dtype, eps, N, C in chip_smoke.layernorm_cases():
        assert (w_dtype, eps) == (param_dtype, 1e-5)


def _inputs(shape, x_dtype, w_dtype, seed):
    rng = np.random.default_rng(seed)
    C = shape[-1]
    x = (rng.standard_normal(shape) * 2 + 0.5).astype(np.float32)
    w = (1 + 0.1 * rng.standard_normal(C)).astype(np.float32)
    b = (0.1 * rng.standard_normal(C)).astype(np.float32)
    tx = torch.from_numpy(x).to(x_dtype)
    tw, tb = (torch.from_numpy(a).to(w_dtype) for a in (w, b))
    # the JAX side gets the very same (rounded) values
    jx = jnp.asarray(tx.float().numpy()).astype(
        jnp.bfloat16 if x_dtype == torch.bfloat16 else jnp.float32)
    jw, jb = (jnp.asarray(t.float().numpy()).astype(
        jnp.bfloat16 if w_dtype == torch.bfloat16 else jnp.float32)
        for t in (tw, tb))
    return (tx, tw, tb), (jx, jw, jb)


def _plans(dtype, shape, groups, w_dtype):
    """The plan the wrapper would take, and plans that split the rows into
    several blocks: a cluster of four ranks, and blocks of the grid or
    two-pass body over ragged row chunks."""
    B, H, W, C = shape
    S = H * W
    plan = tgn.groupnorm_plan(dtype, B, S, C, groups, w_dtype)
    ranks = plan._replace(body="cluster", cluster=4, rows_per_cta=-(-S // 4))
    chunks = plan._replace(body="two_pass", cluster=1, span=C, rows_per_cta=7)
    return {"planned": plan, "four_ranks": ranks, "ragged_chunks": chunks}


def _tol(want, dtype):
    top = float(np.abs(np.asarray(want, np.float32)).max())
    return 2.0 ** -7 * top if dtype == torch.bfloat16 else 1e-5


@pytest.mark.parametrize("split", ["planned", "four_ranks", "ragged_chunks"])
@pytest.mark.parametrize("x_dtype,w_dtype,eps,silu,shape,groups", [
    (torch.float32, torch.float32, 1e-6, True, (2, 8, 12, 64), 32),
    (torch.float32, torch.float32, 1e-5, False, (1, 10, 7, 128), 32),
    (torch.bfloat16, torch.bfloat16, 1e-5, True, (2, 8, 8, 320), 32),
    (torch.bfloat16, torch.bfloat16, 1e-6, False, (3, 6, 6, 640), 32),
    # bf16 activations with the fp32 norm weights of the SD 1.x / 2.x VAE
    (torch.bfloat16, torch.float32, 1e-6, True, (1, 12, 16, 128), 32),
    (torch.bfloat16, torch.float32, 1e-6, False, (1, 8, 8, 512), 32),
    # ragged: 72 channels in 8 groups of 9 (span of 8 groups in bf16)
    (torch.bfloat16, torch.float32, 1e-5, True, (2, 5, 9, 72), 8),
    (torch.float32, torch.float32, 1e-5, True, (1, 9, 5, 72), 8),
], ids=["f32_e6_silu", "f32_e5", "bf16_e5_silu", "bf16_e6", "bf16_w32_e6_silu",
        "bf16_w32_e6", "ragged_bf16_w32", "ragged_f32"])
def test_split_sums_match_jax(x_dtype, w_dtype, eps, silu, shape, groups, split):
    (tx, tw, tb), (jx, jw, jb) = _inputs(shape, x_dtype, w_dtype, seed=7)
    plan = _plans(x_dtype, shape, groups, w_dtype)[split]
    got = tgn.split_group_norm(tx, tw, tb, groups, eps, silu, plan)
    assert got.dtype == x_dtype and got.shape == shape
    got = got.float().numpy()
    plain = np.asarray(j_reference_group_norm(jx, jw, jb, groups, eps=eps,
                                              silu=silu), np.float32)
    kernel = np.asarray(j_fused_group_norm(jx, jw, jb, groups, eps=eps,
                                           silu=silu, interpret=True), np.float32)
    tol = _tol(plain, x_dtype)
    assert np.abs(got - plain).max() <= tol
    assert np.abs(got - kernel).max() <= tol
    # and against the port's own plain twin, the one chip_smoke.py holds
    # the kernel to
    twin = tgn.reference_group_norm(tx, tw, tb, groups, eps, silu).float().numpy()
    assert np.abs(got - twin).max() <= tol


def test_wrapper_counts_copies_only_where_it_launches():
    """The copy counter and the launch counter move only on the card: a CPU
    tensor raises before either."""
    x = torch.zeros(1, 4, 4, 64).permute(0, 2, 1, 3)  # not contiguous
    before = (tgn.fused_group_norm.launches, tgn.fused_group_norm.copies)
    with pytest.raises(RuntimeError, match="CUDA"):
        tgn.fused_group_norm(x, torch.ones(64), torch.zeros(64), 32)
    assert (tgn.fused_group_norm.launches, tgn.fused_group_norm.copies) == before
