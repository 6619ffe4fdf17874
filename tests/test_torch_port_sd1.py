"""SD 1.x in the port: the attention head dims 40 / 80 / 160 (8 heads at
320 / 640 / 1280 channels) against the JAX package's Pallas kernels in
interpret mode, a toy UNet whose attention blocks have 8 heads of dim 40
against the JAX UNet, and the SD 1.5 bundle configuration. fp32 on the CPU.
"""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elasticdiffusion_tpu.kernels import flash_attention as jfa
from toy_configs import TOY_RUNTIME, TOY_UNET, toy_bundle_config

from elasticdiffusion_tpu_torch import configs as tcfg
from elasticdiffusion_tpu_torch.kernels import attention as tattn
from elasticdiffusion_tpu_torch.kernels.flash_attention import (
    HEAD_DIMS, flash_attention, reference_attention)
from elasticdiffusion_tpu_torch.models.convert import unet_from_jax
from elasticdiffusion_tpu_torch.models.registry import load_bundle
from torch_port_common import (TORCH_TOY_RUNTIME, max_abs, port_bundle_config,
                               t2n, to_numpy_tree)

ATTN_TOL = 2e-5  # fp32 on both sides, sums in another order


@pytest.mark.parametrize("D", [40, 80, 160])
@pytest.mark.parametrize("Sk", [256, 77])
def test_sd1_head_dims_match_jax_flash_kernel(D, Sk):
    rng = np.random.default_rng(D + Sk)
    q = rng.standard_normal((1, 256, 2, D)).astype(np.float32)
    k = rng.standard_normal((1, Sk, 2, D)).astype(np.float32)
    v = rng.standard_normal((1, Sk, 2, D)).astype(np.float32)
    want = np.asarray(jfa.flash_attention(
        *map(jnp.asarray, (q, k, v)), block_q=128, block_k=128, interpret=True,
        oneshot="on"))
    tq = torch.from_numpy(q)
    assert D in HEAD_DIMS and tattn.in_gate(tq, causal=False)
    before = flash_attention.launches
    got = t2n(tattn.dot_product_attention(tq, torch.from_numpy(k),
                                          torch.from_numpy(v)))
    assert flash_attention.launches == before  # no kernel on the CPU
    assert max_abs(got, want) < ATTN_TOL
    plain = t2n(reference_attention(tq, torch.from_numpy(k), torch.from_numpy(v)))
    assert max_abs(plain, want) < ATTN_TOL


def test_sd1_streaming_kernel_at_head_dim_40():
    """The JAX package's fp32 streaming kernel (long keys at D=40)."""
    rng = np.random.default_rng(7)
    q, k, v = (rng.standard_normal((1, 256, 1, 40)).astype(np.float32)
               for _ in range(3))
    want = np.asarray(jfa.flash_attention(
        *map(jnp.asarray, (q, k, v)), block_q=128, block_k=128, interpret=True,
        oneshot="off"))
    got = t2n(reference_attention(*map(torch.from_numpy, (q, k, v))))
    assert max_abs(got, want) < ATTN_TOL


@pytest.mark.parametrize("version", ["1.4", "1.5"])
def test_sd1_bundle_config_gives_the_kernel_its_head_dims(version):
    cfg = tcfg.get_bundle_config(version)
    u = cfg.unet
    dims = [u.block_out_channels[i] // u.heads_for_block(i) for i in range(4)]
    assert dims == [40, 80, 160, 160] and set(dims) <= set(HEAD_DIMS)
    assert cfg.text_encoders == (tcfg.CLIP_VIT_L_14,)
    assert cfg.text_encoders[0].hidden_act == "quick_gelu"
    assert not cfg.is_xl and u.cross_attention_dim == 768
    assert not u.use_linear_projection


# 8 heads of dim 40 in the attention block, as SD 1.x's first block
TOY_UNET_SD1 = dataclasses.replace(TOY_UNET, block_out_channels=(320, 64),
                                   attention_head_dim=(8, 8))


@functools.lru_cache(maxsize=1)
def _sd1_toy_bundles():
    from elasticdiffusion_tpu.models.registry import load_bundle as j_load_bundle
    jcfg = dataclasses.replace(toy_bundle_config(), unet=TOY_UNET_SD1)
    jb = j_load_bundle("toy", runtime=TOY_RUNTIME, bundle_config=jcfg)
    tb = load_bundle("toy", TORCH_TOY_RUNTIME,
                     bundle_config=port_bundle_config(jcfg), device="cpu")
    tb.unet.load_state_dict(unet_from_jax(to_numpy_tree(jb.unet_params)))
    return jb, tb


@pytest.mark.parametrize("hw,conv_impl", [((8, 8), "cudnn"), ((16, 16), "cudnn"),
                                          ((16, 16), "kernel")])
def test_toy_unet_with_head_dim_40_matches_jax(hw, conv_impl):
    """64 tokens stay below the attention gate, 256 are inside it."""
    jb, tb = _sd1_toy_bundles()
    attn = tb.unet.down_blocks[0].attentions[0].transformer_blocks[0].attn1
    assert (attn.num_heads, attn.head_dim) == (8, 40)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 4) + hw).astype(np.float32)
    ctx = rng.standard_normal((2, 77, 16)).astype(np.float32)
    want = jb.apply_unet(jnp.asarray(x), jnp.float32(500.0), jnp.asarray(ctx))
    tb.set_conv_impl(conv_impl)
    try:
        got = tb.apply_unet(torch.from_numpy(x), 500.0, torch.from_numpy(ctx))
    finally:
        tb.set_conv_impl("cudnn")
    assert got.shape == x.shape
    assert max_abs(t2n(got), np.asarray(want)) < 5e-5


def test_flash_attention_wrapper_takes_every_built_head_dim_or_raises_on_cpu():
    """No head dim of the built list is refused before the device check."""
    for D in HEAD_DIMS:
        with pytest.raises(RuntimeError, match="CUDA"):
            flash_attention(*(torch.zeros(1, 256, 1, D),) * 3)
