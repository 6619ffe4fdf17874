"""The ``--fp32`` configuration: the plans of its kernel bodies, the
three-pass TF32 arithmetic of those bodies held to the JAX package, and the
fp32 UNet and ControlNet forwards kept out of TF32.

The fp32 attention at the UNet head dims and the fp32 conv3x3 run on the
tensor cores in three TF32 passes (``csrc/sm90.cuh``: each operand split
as hi + lo, a_lo b_hi + a_hi b_lo + a_hi b_hi into one fp32 accumulator).
The kernels run only on the GPU; here their arithmetic is emulated on the
CPU (TF32 rounding by integer rounding of the fp32 bits, as
``cvt.rna.tf32.f32`` rounds) and held, in fp32, to the JAX package's
reference functions and its Pallas kernels in interpret mode within the
band ``chip_smoke.compare`` holds the kernels to on the card (2e-5). One
TF32 pass misses that band, which is why the bodies take three.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elasticdiffusion_tpu.kernels import flash_attention as jfa
from elasticdiffusion_tpu.kernels.attention import (
    reference_attention as j_reference_attention)
from elasticdiffusion_tpu.kernels.conv3x3 import (
    conv3x3 as j_conv3x3, reference_conv3x3 as j_reference_conv3x3)

from elasticdiffusion_tpu_torch.configs import RuntimeConfig
from elasticdiffusion_tpu_torch.kernels.conv3x3 import (
    MAX_SPLITS, SM_COUNT, SMEM_PER_BLOCK, TC_BK, TC_BM, TC_BN, WGMMA_TILES,
    _tc_est_us, conv_plan, split_k_conv3x3, tc_plan)
from elasticdiffusion_tpu_torch.kernels.flash_attention import (
    TC_TILES, WGMMA_TILES as ATTN_WGMMA_TILES, attention_plan)
from elasticdiffusion_tpu_torch.models.registry import load_bundle
from torch_port_common import port_bundle_config
from toy_configs import toy_bundle_config

F32, BF16 = torch.float32, torch.bfloat16
BAND = 2e-5  # chip_smoke.compare's fp32 band, absolute (x max(top, 1)) and rel L2

# the attention shapes of the --fp32 paths' kernel cases (chip_smoke.py):
# SD 1.5, SD 2.1 and SDXL UNet blocks, (S, H, D)
FP32_ATTENTION = ((4096, 8, 40), (1024, 8, 80), (256, 8, 160),
                  (4096, 5, 64), (1024, 10, 64), (256, 20, 64),
                  (4096, 10, 64), (1024, 20, 64))
BATCHES = (8, 2, 3)
# SD 1.5's (and SD 2.1's) UNet convolutions: (latent side, C, O)
SD_CONVS = ((64, 320, 320), (32, 640, 640), (16, 1280, 1280),
            (8, 1280, 1280), (16, 2560, 1280), (8, 2560, 1280),
            (16, 640, 1280), (16, 1920, 1280), (32, 320, 640),
            (32, 1920, 640), (32, 1280, 640), (32, 960, 640),
            (64, 960, 320), (64, 640, 320), (32, 1280, 1280), (64, 640, 640))


# ---------------------------------------------------------------------------
# (a) the plans
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S,H,D", FP32_ATTENTION)
@pytest.mark.parametrize("B", BATCHES)
@pytest.mark.parametrize("Sk", ["self", 77])
def test_fp32_attention_takes_the_three_pass_body(S, H, D, B, Sk):
    Sk = S if Sk == "self" else Sk
    plan = attention_plan(F32, B, S, Sk, H, D)
    bn, stages = TC_TILES[D]
    ld = -(-D // 32) * 32 + 4
    assert (plan.body, plan.code, plan.splits) == ("mma.tf32x3", 0, 1)
    # four warps of 16 query rows
    assert (plan.bm, plan.bn, plan.stages, plan.threads) == (
        64, bn, stages, 128)
    assert plan.blocks == B * H * math.ceil(S / plan.bm)
    # Q and the ring's K and V tiles in rows of LD = 4 mod 32 floats
    assert ld % 32 == 4 and plan.smem_bytes == (
        (plan.bm + 2 * stages * bn) * ld * 4) <= SMEM_PER_BLOCK


@pytest.mark.parametrize("S", [704, 4096, 6144, 24576, 36864, 65536])
def test_fp32_head_dim_512_keeps_its_fma_body(S):
    assert attention_plan(F32, 1, S, S, 1, 512).body == "fma.tiled"


@pytest.mark.parametrize("S,H,D", FP32_ATTENTION)
@pytest.mark.parametrize("Sk", ["self", 77])
def test_bf16_attention_plans_are_unchanged(S, H, D, Sk):
    """The bf16 plans at the same shapes: the wgmma body's rule, as
    before."""
    Sk = S if Sk == "self" else Sk
    for B in BATCHES:
        plan = attention_plan(BF16, B, S, Sk, H, D)
        (bn1, st1), st2 = ATTN_WGMMA_TILES[D]
        if Sk <= 80:
            want = (3, 64, 80, 1)
        elif B * H * math.ceil(S / 128) >= SM_COUNT:
            want = (1, 128, bn1, st1)
        else:
            want = (2, 64, 64, st2)
        assert plan.body == "wgmma"
        assert (plan.code, plan.bm, plan.bn, plan.stages) == want


@pytest.mark.parametrize("S,C,O", SD_CONVS)
@pytest.mark.parametrize("B", BATCHES)
def test_fp32_conv_takes_the_three_pass_body(S, C, O, B):
    plan = conv_plan(F32, B, S, S, C, O)
    assert plan == tc_plan(B, S, S, C, O)
    assert (plan.body, plan.code, plan.tile, plan.bn) == (
        "mma.tf32x3", 0, (TC_BM, 1, 1), TC_BN)
    tiles = math.ceil(B * S * S / TC_BM) * math.ceil(O / TC_BN)
    kiters = 9 * math.ceil(C / TC_BK)
    assert plan.items == plan.blocks == tiles * plan.splits
    # splits only where the tiles cannot fill two block places on every SM,
    # never below one chunk of every tap; no split count the cost model
    # rates 5 % faster than the chosen one, and the chosen one no slower
    # than none
    cost = lambda z: _tc_est_us(tiles, kiters, z, B * S * S * O)
    assert 1 <= plan.splits <= max(1, min(MAX_SPLITS, kiters // 9))
    if tiles >= 2 * SM_COUNT:
        assert plan.splits == 1
    else:
        assert all(cost(z) >= 0.95 * cost(plan.splits)
                   for z in range(1, min(MAX_SPLITS, kiters // 9) + 1))
    assert cost(plan.splits) <= cost(1)
    # two blocks fit an SM's 228 KB (1 KB reserved a block)
    assert 2 * (plan.smem_bytes + 1024) <= 228 * 1024
    # the bf16 plan of the same shape is the wgmma body, as before
    bf = conv_plan(BF16, B, S, S, C, O)
    assert bf.body == "wgmma" and bf.code in WGMMA_TILES


# ---------------------------------------------------------------------------
# (b), (c) the three-pass arithmetic against the JAX package
# ---------------------------------------------------------------------------

def tf32(x: np.ndarray) -> np.ndarray:
    """fp32 -> TF32 (10 stored mantissa bits) to nearest, ties away from
    zero, as cvt.rna.tf32.f32: add half of the dropped range to the bits of
    the magnitude and clear the 13 low bits."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def split(x: np.ndarray):
    hi = tf32(x)
    return hi, tf32((x - hi).astype(np.float32))


def matmul3(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """a @ b as the bodies take it: a_lo b_hi + a_hi b_lo + a_hi b_hi, each
    product exact in fp32 (two 11-bit significands), summed in fp32."""
    (ah, al), (bh, bl) = split(a), split(b)
    t = torch.from_numpy
    out = t(al) @ t(bh)
    out += t(ah) @ t(bl)
    out += t(ah) @ t(bh)
    return out.numpy()


def matmul1(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """a @ b in one TF32 pass."""
    return (torch.from_numpy(tf32(a)) @ torch.from_numpy(tf32(b))).numpy()


def emulated_attention(q, k, v, mm):
    """(B, Sq, H, D) attention with both products through `mm`, the softmax
    in fp32 as the body runs it (exp2 of the scaled logits, the
    denominator from the unrounded P)."""
    D = q.shape[-1]
    qh, kh, vh = (np.ascontiguousarray(x.transpose(0, 2, 1, 3))
                  for x in (q, k, v))
    s = mm(qh, kh.transpose(0, 1, 3, 2))
    c = np.float32(math.log2(math.e) / math.sqrt(D))
    p = np.exp2((s - s.max(-1, keepdims=True)) * c).astype(np.float32)
    o = mm(p, vh) / p.sum(-1, keepdims=True)
    return o.transpose(0, 2, 1, 3)


def band_errors(got, ref):
    """(max abs over the band's absolute bar, rel L2): within the band when
    both are at most 1 and 2e-5."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    bar = BAND * max(np.abs(ref).max(), 1.0)
    rel = np.linalg.norm(got - ref) / np.linalg.norm(ref)
    return np.abs(got - ref).max() / bar, rel


@pytest.fixture(scope="module", params=[(40, 77), (40, 256), (64, 77),
                                        (64, 256), (80, 77), (80, 256),
                                        (160, 77), (160, 256)],
                ids=lambda p: f"D{p[0]}-Sk{p[1]}")
def attention_case(request):
    """fp32 q, k, v (1, 256, 2, D) x (1, Sk, 2, D) from a seed; the JAX
    reference attention and the Pallas one-shot kernel (interpret mode) on
    them, in fp32."""
    D, Sk = request.param
    rng = np.random.default_rng(1300 + D + Sk)
    q = rng.standard_normal((1, 256, 2, D)).astype(np.float32)
    k, v = (rng.standard_normal((1, Sk, 2, D)).astype(np.float32)
            for _ in range(2))
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    ref = np.asarray(j_reference_attention(jq, jk, jv))
    pallas = np.asarray(jfa.flash_attention(jq, jk, jv, interpret=True,
                                            oneshot="on"))
    return (q, k, v), ref, pallas


def test_three_pass_attention_is_within_the_fp32_band(attention_case):
    (q, k, v), ref, pallas = attention_case
    got = emulated_attention(q, k, v, matmul3)
    for want in (ref, pallas):
        abs_ratio, rel = band_errors(got, want)
        assert abs_ratio <= 1.0 and rel <= BAND, (abs_ratio, rel)


def test_one_tf32_pass_misses_the_attention_band(attention_case):
    (q, k, v), ref, _ = attention_case
    abs_ratio, rel = band_errors(emulated_attention(q, k, v, matmul1), ref)
    assert rel > BAND and abs_ratio > 1.0


def emulated_conv3x3(x, w, bias, silu, mm):
    """SAME 3x3 NHWC convolution as nine (pixels x C) @ (C x O) products
    through `mm`, summed in fp32, then bias and SiLU in fp32."""
    B, H, W, C = x.shape
    xp = np.pad(x, ((0, 0), (1, 1), (1, 1), (0, 0)))
    acc = np.zeros((B * H * W, w.shape[-1]), np.float32)
    for dy in range(3):
        for dx in range(3):
            a = np.ascontiguousarray(xp[:, dy:dy + H, dx:dx + W]).reshape(-1, C)
            acc += mm(a, np.ascontiguousarray(w[dy, dx]))
    acc = acc.reshape(B, H, W, -1) + bias
    if silu:
        acc = acc / (1.0 + np.exp(-acc))
    return acc.astype(np.float32)


@pytest.fixture(scope="module", params=[(2, 8, 8, 64, 32, False),
                                        (1, 8, 16, 136, 24, True),
                                        (3, 4, 8, 320, 40, True)],
                ids=lambda p: "x".join(map(str, p[:5])))
def conv_case(request):
    """fp32 x, w (fan-in scaled), bias from a seed, and the JAX reference
    conv3x3 and Pallas kernel (interpret mode) on them."""
    B, H, W, C, O, silu = request.param
    rng = np.random.default_rng(1313 + C)
    x = rng.standard_normal((B, H, W, C)).astype(np.float32)
    w = (rng.standard_normal((3, 3, C, O)) / math.sqrt(9 * C)).astype(
        np.float32)
    b = (0.1 * rng.standard_normal(O)).astype(np.float32)
    jx, jw, jb = map(jnp.asarray, (x, w, b))
    ref = np.asarray(j_reference_conv3x3(jx, jw, jb, silu_out=silu))
    pallas = np.asarray(j_conv3x3(jx, jw, jb, silu_out=silu, interpret=True))
    return (x, w, b, silu), ref, pallas


def test_three_pass_conv_is_within_the_fp32_band(conv_case):
    (x, w, b, silu), ref, pallas = conv_case
    got = emulated_conv3x3(x, w, b, silu, matmul3)
    for want in (ref, pallas):
        abs_ratio, rel = band_errors(got, want)
        assert abs_ratio <= 1.0 and rel <= BAND, (abs_ratio, rel)


def test_one_tf32_pass_misses_the_conv_band(conv_case):
    (x, w, b, silu), ref, _ = conv_case
    abs_ratio, rel = band_errors(emulated_conv3x3(x, w, b, silu, matmul1), ref)
    assert rel > BAND


def test_fp32_split_k_sum_at_its_planned_splits(conv_case):
    """The fp32 body's split K loop (32-channel chunks x 9 taps, cut as
    ``tc_plan`` cuts it; here at every split count up to the plan's cap)
    summed in split order, against the JAX reference."""
    (x, w, b, silu), ref, _ = conv_case
    B, H, W, C = x.shape
    tx, tw, tb = map(torch.from_numpy, (x, w, b))
    plan = tc_plan(B, H, W, C, w.shape[-1])
    for splits in sorted({1, plan.splits, 9 * math.ceil(C / TC_BK) // 9}):
        got = split_k_conv3x3(tx, tw, tb, silu, splits, chunk=TC_BK).numpy()
        abs_ratio, rel = band_errors(got, ref)
        assert abs_ratio <= 1.0 and rel <= BAND, (splits, abs_ratio, rel)


# ---------------------------------------------------------------------------
# (d) the fp32 UNet and ControlNet forwards keep cuDNN out of TF32
# ---------------------------------------------------------------------------

def _toy_bundle(dtype):
    return load_bundle("toy", RuntimeConfig(param_dtype=dtype,
                                            compute_dtype=dtype),
                       bundle_config=port_bundle_config(toy_bundle_config()),
                       controlnet_model="canny", device="cpu")


@pytest.mark.parametrize("dtype", [F32, BF16], ids=["fp32", "bf16"])
def test_forwards_read_tf32_off(dtype):
    """With the global flag at PyTorch's default (True), a hook inside the
    toy UNet's and ControlNet's forwards and the compute-dtype decode reads
    False (in bf16 the flag changes nothing: it touches only fp32
    convolutions); the flag is the default again after each call."""
    bundle = _toy_bundle(dtype)
    seen = []
    hooks = [m.register_forward_pre_hook(
        lambda mod, args: seen.append(torch.backends.cudnn.allow_tf32))
        for m in (bundle.unet, bundle.controlnet, bundle.vae.post_quant_conv)]
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        g = torch.Generator().manual_seed(13)
        lat = torch.randn(2, 4, 8, 8, generator=g).to(dtype)
        ctx = torch.randn(2, 77, 16, generator=g).to(dtype)
        f = bundle.vae_scale_factor
        cond = torch.rand(2, 3, 8 * f, 8 * f, generator=g).to(dtype)
        down, mid = bundle.apply_controlnet(lat, 501.0, ctx, cond)
        assert torch.backends.cudnn.allow_tf32
        eps = bundle.apply_unet(lat, 501.0, ctx, down_block_residuals=down,
                                mid_block_residual=mid)
        assert torch.backends.cudnn.allow_tf32
        img = bundle.vae_decode(lat.float())
        assert torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32 = prev
        for h in hooks:
            h.remove()
    assert seen == [False] * 3
    assert eps.dtype == dtype and torch.isfinite(eps.float()).all()
    assert torch.isfinite(img.float()).all()


def test_tf32_flag_comes_back_after_a_failing_fp32_forward():
    bundle = _toy_bundle(F32)
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        with pytest.raises(Exception):
            bundle.apply_unet(torch.zeros(1, 3, 8, 8), 1.0,
                              torch.zeros(1, 77, 16))  # 3 channels, not 4
        assert torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32 = prev
