"""The port's plain kernel versions against the JAX package's kernels.

On the CPU a wrapper takes its kernel's plain version, and only because the
tensor lies on the CPU. The JAX Pallas kernels run in interpret mode, as
tests/test_kernels.py runs them. Same numpy inputs on both sides, fp32.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elasticdiffusion_tpu.kernels import flash_attention as jfa
from elasticdiffusion_tpu.kernels.attention import (
    reference_attention as j_reference_attention)
from elasticdiffusion_tpu.kernels.groupnorm import (
    fused_group_norm as j_fused_group_norm,
    reference_group_norm as j_reference_group_norm)
from elasticdiffusion_tpu.kernels.layernorm import (
    fused_layer_norm as j_fused_layer_norm)

from elasticdiffusion_tpu_torch.kernels import attention as tattn
from elasticdiffusion_tpu_torch.kernels import groupnorm as tgn
from elasticdiffusion_tpu_torch.kernels import layernorm as tln
from elasticdiffusion_tpu_torch.kernels.flash_attention import (
    flash_attention, reference_attention)
from torch_port_common import max_abs, t2n


def _qkv(seed, B, Sq, Sk, H, D):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Sq, H, D)).astype(np.float32),
            rng.standard_normal((B, Sk, H, D)).astype(np.float32),
            rng.standard_normal((B, Sk, H, D)).astype(np.float32))


# fp32 on both sides; the sums run in another order: 2e-5, the bar of
# tests/test_kernels.py
ATTN_TOL = 2e-5


@pytest.mark.parametrize("B,Sq,Sk,H,D,causal", [
    (2, 64, 64, 2, 16, False),
    (1, 256, 77, 2, 64, False),    # cross-attention on the text tokens
    (1, 77, 77, 2, 8, True),       # CLIP's causal attention
    (1, 48, 48, 1, 512, False),    # the VAE mid block's head dim
])
def test_reference_attention_matches_jax_reference(B, Sq, Sk, H, D, causal):
    q, k, v = _qkv(0, B, Sq, Sk, H, D)
    want = np.asarray(j_reference_attention(*map(jnp.asarray, (q, k, v)),
                                            causal=causal))
    got = t2n(reference_attention(*map(torch.from_numpy, (q, k, v)),
                                  causal=causal))
    assert got.shape == want.shape
    assert max_abs(got, want) < ATTN_TOL


@pytest.mark.parametrize("B,Sq,Sk,H,D,oneshot", [
    (1, 256, 256, 2, 64, "on"),    # the one-shot kernel (UNet self-attention)
    (1, 256, 77, 2, 64, "on"),     # ragged keys, padded and masked
    (1, 256, 256, 1, 512, "off"),  # the streaming kernel at the VAE head dim
    (1, 256, 384, 2, 64, "off"),
])
def test_dispatch_matches_jax_flash_kernel(B, Sq, Sk, H, D, oneshot):
    """Inside the gate, on a CPU tensor, the dispatch takes the plain
    version; it computes what the Pallas kernel computes."""
    q, k, v = _qkv(1, B, Sq, Sk, H, D)
    want = np.asarray(jfa.flash_attention(
        *map(jnp.asarray, (q, k, v)), block_q=128, block_k=128,
        interpret=True, oneshot=oneshot))
    tq = torch.from_numpy(q)
    assert tattn.in_gate(tq, causal=False)
    before = flash_attention.launches
    got = t2n(tattn.dot_product_attention(tq, torch.from_numpy(k),
                                          torch.from_numpy(v)))
    assert flash_attention.launches == before  # no kernel on the CPU
    assert max_abs(got, want) < ATTN_TOL


def test_attention_bf16_casts_probabilities_to_v_dtype():
    """bf16 contract: fp32 softmax, P cast to V's dtype, output bf16."""
    q, k, v = _qkv(2, 1, 32, 32, 2, 16)
    tq, tk, tv = (torch.from_numpy(a).bfloat16() for a in (q, k, v))
    got = reference_attention(tq, tk, tv)
    assert got.dtype == torch.bfloat16
    want = np.asarray(j_reference_attention(
        *(jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v))
    ).astype(jnp.float32))
    # one bf16 ulp (2^-8 relative) of values below 1
    assert max_abs(t2n(got.float()), want) < 2 ** -7


# fp32 statistics on both sides; the interpret-mode kernel and the plain
# version differ in sum order only
NORM_TOL = 1e-5


@pytest.mark.parametrize("shape", [(16, 128), (2, 24, 256), (8, 40)])
def test_layer_norm_matches_jax_kernel(shape):
    rng = np.random.default_rng(3)
    x = (rng.standard_normal(shape) * 2 + 0.5).astype(np.float32)
    C = shape[-1]
    w = (1 + 0.1 * rng.standard_normal(C)).astype(np.float32)
    b = (0.1 * rng.standard_normal(C)).astype(np.float32)
    got = t2n(tln.layer_norm(*map(torch.from_numpy, (x, w, b)), eps=1e-5))
    if C % 128 == 0:
        want = j_fused_layer_norm(*map(jnp.asarray, (x, w, b)), eps=1e-5,
                                  interpret=True)
    else:  # outside the TPU kernel's layout gate: its own plain version
        from elasticdiffusion_tpu.kernels.layernorm import reference_layer_norm
        want = reference_layer_norm(*map(jnp.asarray, (x, w, b)), 1e-5)
    assert max_abs(got, np.asarray(want)) < NORM_TOL


@pytest.mark.parametrize("silu", [False, True])
@pytest.mark.parametrize("B,H,W,C,groups", [(2, 8, 8, 64, 32), (1, 6, 10, 32, 8)])
def test_group_norm_matches_jax_kernel(B, H, W, C, groups, silu):
    rng = np.random.default_rng(4)
    x = (rng.standard_normal((B, H, W, C)) * 2 + 0.5).astype(np.float32)
    w = (1 + 0.1 * rng.standard_normal(C)).astype(np.float32)
    b = (0.1 * rng.standard_normal(C)).astype(np.float32)
    got = t2n(tgn.group_norm(*map(torch.from_numpy, (x, w, b)), groups,
                             eps=1e-6, silu=silu))
    kernel = j_fused_group_norm(*map(jnp.asarray, (x, w, b)), groups, eps=1e-6,
                                silu=silu, interpret=True)
    plain = j_reference_group_norm(*map(jnp.asarray, (x, w, b)), groups,
                                   eps=1e-6, silu=silu)
    assert max_abs(got, np.asarray(kernel)) < NORM_TOL
    assert max_abs(got, np.asarray(plain)) < NORM_TOL


def test_norms_keep_input_dtype_with_fp32_statistics():
    x = torch.randn(2, 4, 4, 32, generator=torch.Generator().manual_seed(0))
    w, b = torch.ones(32), torch.zeros(32)
    out = tgn.reference_group_norm(x.bfloat16(), w.bfloat16(), b, 8)
    assert out.dtype == torch.bfloat16
    out = tln.reference_layer_norm(x.bfloat16(), w, b.bfloat16())
    assert out.dtype == torch.bfloat16


@pytest.mark.parametrize("call", [
    lambda m: tattn.dot_product_attention(torch.zeros(1, 256, 1, 8),
                                          torch.zeros(1, 4, 1, 8),
                                          torch.zeros(1, 4, 1, 8),
                                          use_kernels=m),
    lambda m: tln.layer_norm(torch.zeros(2, 8), torch.ones(8), torch.zeros(8),
                             use_kernels=m),
    lambda m: tgn.group_norm(torch.zeros(1, 2, 2, 8), torch.ones(8),
                             torch.zeros(8), 2, use_kernels=m),
], ids=["attention", "layer_norm", "group_norm"])
def test_use_kernels_modes_on_cpu_tensor(call):
    """'auto' and 'off' take the plain version on a CPU tensor; 'on' raises;
    an unknown mode raises."""
    assert torch.isfinite(call("auto")).all()
    assert torch.isfinite(call("off")).all()
    with pytest.raises(RuntimeError, match="CUDA tensor"):
        call("on")
    with pytest.raises(ValueError):
        call("sometimes")


@pytest.mark.parametrize("wrapper,args", [
    (flash_attention, (torch.zeros(1, 256, 1, 64),) * 3),
    (tln.fused_layer_norm, (torch.zeros(2, 8), torch.ones(8), torch.zeros(8))),
    (tgn.fused_group_norm, (torch.zeros(1, 2, 2, 8), torch.ones(8),
                            torch.zeros(8), 2)),
], ids=["flash_attention", "fused_layer_norm", "fused_group_norm"])
def test_kernel_wrappers_refuse_cpu_tensors(wrapper, args):
    """A kernel wrapper never computes on the CPU: it launches or raises."""
    before = wrapper.launches
    with pytest.raises(RuntimeError, match="CUDA"):
        wrapper(*args)
    assert wrapper.launches == before


def test_below_the_gate_plain_ops_run():
    """Short or causal queries stay on plain ops, as in the JAX package."""
    assert not tattn.in_gate(torch.zeros(1, 64, 1, 64), causal=False)
    assert not tattn.in_gate(torch.zeros(1, 512, 1, 64), causal=True)
    assert not tattn.in_gate(torch.zeros(1, 512, 1, 12), causal=False)
    assert tattn.in_gate(torch.zeros(1, 256, 1, 40), causal=False)
