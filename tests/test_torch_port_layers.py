"""Each block of the port's models/layers.py against its Flax twin.

The Flax module is initialised from a seed, its parameters are carried
across with the leaf rules of models/convert.py, and the same numpy input
goes through both. The JAX blocks are NHWC, the port's NCHW: inputs and
outputs are transposed at the boundary. fp32 on both sides; the bar is the
3e-5 of tests/test_torch_goldens.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elasticdiffusion_tpu.models import layers as jl
from elasticdiffusion_tpu_torch.models import convert as tconv
from elasticdiffusion_tpu_torch.models import layers as tl
from torch_port_common import max_abs, t2n

TOL = 3e-5


def _init(module, *args, seed=0):
    params = module.init(jax.random.PRNGKey(seed), *args)["params"]
    # biases and norm parameters away from their 0 / 1 init, so a swapped or
    # dropped one shows
    leaves, treedef = jax.tree.flatten(params)
    rng = np.random.default_rng(seed + 1)
    leaves = [np.asarray(l) + 0.1 * rng.standard_normal(l.shape).astype(np.float32)
              for l in leaves]
    return jax.tree.unflatten(treedef, leaves)


def _carry(tmod, params, namer):
    """Load Flax `params` into torch module `tmod`; namer maps a Flax module
    path (without the leaf) to the port's module name ('' for the root)."""
    sd = {}
    for path, value in tconv._flatten(params):
        leaf, tensor = tconv._leaf(path[-1], value)
        mod = namer(path[:-1])
        sd[f"{mod}.{leaf}" if mod else leaf] = tensor
    tmod.load_state_dict(sd)
    return tmod.eval()


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t2n(t).transpose(0, 2, 3, 1)


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("dim,flip,shift", [(32, True, 0.0), (32, False, 1.0),
                                            (7, True, 0.0)])
def test_timestep_embedding(dim, flip, shift):
    t = np.asarray([1.0, 501.0, 999.0], np.float32)
    want = jl.timestep_embedding(jnp.asarray(t), dim, flip, shift)
    got = tl.timestep_embedding(torch.from_numpy(t), dim, flip, shift)
    # sin/cos of arguments up to 1e3 in fp32: the argument's own rounding
    assert max_abs(t2n(got), np.asarray(want)) < 2e-4


@pytest.mark.parametrize("C,silu", [(64, False), (64, True), (8, True), (12, False)])
def test_group_norm32_with_group_clamp(C, silu):
    x = _x((2, 5, 6, C)) * 2 + 0.3
    jm = jl.GroupNorm32(epsilon=1e-6, silu=silu)
    params = _init(jm, jnp.asarray(x))
    tm = _carry(tl.GroupNorm32(C, eps=1e-6, silu=silu), params, lambda p: "")
    assert tm.groups == max(1, min(np.gcd(C, 32) if C % 32 else 32, C // 4))
    want = jm.apply({"params": params}, jnp.asarray(x))
    assert max_abs(_nhwc(tm(_nchw(x))), np.asarray(want)) < TOL


def test_layer_norm32():
    x = _x((2, 9, 48)) * 3 - 0.2
    jm = jl.LayerNorm32()
    params = _init(jm, jnp.asarray(x))
    tm = _carry(tl.LayerNorm32(48), params, lambda p: "")
    want = jm.apply({"params": params}, jnp.asarray(x))
    assert max_abs(t2n(tm(torch.from_numpy(x))), np.asarray(want)) < TOL


def test_timestep_embedding_mlp():
    x = _x((3, 16))
    jm = jl.TimestepEmbedding(40)
    params = _init(jm, jnp.asarray(x))
    tm = _carry(tl.TimestepEmbedding(16, 40), params, lambda p: p[0])
    want = jm.apply({"params": params}, jnp.asarray(x))
    assert max_abs(t2n(tm(torch.from_numpy(x))), np.asarray(want)) < TOL


@pytest.mark.parametrize("cin,cout,temb,eps", [(16, 16, True, 1e-5),
                                               (16, 32, True, 1e-5),
                                               (8, 16, False, 1e-6)])
def test_resnet_block(cin, cout, temb, eps):
    x = _x((2, 6, 5, cin))
    e = _x((2, 24), 1) if temb else None
    jm = jl.ResnetBlock2D(cout, use_temb=temb, norm_eps=eps)
    args = (jnp.asarray(x),) + ((jnp.asarray(e),) if temb else ())
    params = _init(jm, *args)
    tm = _carry(tl.ResnetBlock2D(cin, cout, 24 if temb else None, norm_eps=eps),
                params, tconv._resnet)
    want = jm.apply({"params": params}, *args)
    got = tm(_nchw(x), torch.from_numpy(e) if temb else None)
    assert max_abs(_nhwc(got), np.asarray(want)) < TOL


@pytest.mark.parametrize("cross,bias", [(False, False), (True, False), (False, True)])
def test_cross_attention(cross, bias):
    x = _x((2, 20, 16))
    ctx = _x((2, 7, 12), 1) if cross else None
    jm = jl.CrossAttention(num_heads=2, head_dim=8, qkv_bias=bias, use_pallas="off")
    args = (jnp.asarray(x),) + ((jnp.asarray(ctx),) if cross else ())
    params = _init(jm, *args)
    tm = _carry(tl.CrossAttention(16, 12 if cross else None, 2, 8, qkv_bias=bias),
                params, tconv._attention)
    want = jm.apply({"params": params}, *args)
    got = tm(torch.from_numpy(x), torch.from_numpy(ctx) if cross else None)
    assert max_abs(t2n(got), np.asarray(want)) < TOL


def test_geglu_feed_forward():
    x = _x((2, 10, 16))
    jm = jl.GEGLUFeedForward(16)
    params = _init(jm, jnp.asarray(x))
    tm = _carry(tl.GEGLUFeedForward(16), params,
                lambda p: {"proj_in": "net.0.proj", "proj_out": "net.2"}[p[0]])
    want = jm.apply({"params": params}, jnp.asarray(x))
    assert max_abs(t2n(tm(torch.from_numpy(x))), np.asarray(want)) < TOL


def test_basic_transformer_block():
    x, ctx = _x((2, 12, 16)), _x((2, 7, 24), 1)
    jm = jl.BasicTransformerBlock(2, 8, use_pallas="off")
    params = _init(jm, jnp.asarray(x), jnp.asarray(ctx))
    namer = lambda p: tconv._transformer(("blocks_0",) + p)[len("transformer_blocks.0."):]
    tm = _carry(tl.BasicTransformerBlock(16, 2, 8, 24), params, namer)
    want = jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(ctx))
    got = tm(torch.from_numpy(x), torch.from_numpy(ctx))
    assert max_abs(t2n(got), np.asarray(want)) < TOL


@pytest.mark.parametrize("linear,depth", [(True, 1), (False, 2)])
def test_transformer2d(linear, depth):
    x, ctx = _x((2, 4, 6, 16)), _x((2, 7, 24), 1)
    jm = jl.Transformer2D(2, 8, depth=depth, use_linear_projection=linear,
                          use_pallas="off")
    params = _init(jm, jnp.asarray(x), jnp.asarray(ctx))
    tm = _carry(tl.Transformer2D(16, 2, 8, 24, depth=depth,
                                 use_linear_projection=linear),
                params, tconv._transformer)
    want = jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(ctx))
    got = tm(_nchw(x), torch.from_numpy(ctx))
    assert max_abs(_nhwc(got), np.asarray(want)) < TOL


@pytest.mark.parametrize("pad,hw", [((1, 1), (8, 6)), ((0, 1), (8, 6)),
                                    ((0, 1), (7, 9))])
def test_downsample(pad, hw):
    x = _x((2,) + hw + (8,))
    jm = jl.Downsample2D(8, pad=pad)
    params = _init(jm, jnp.asarray(x))
    tm = _carry(tl.Downsample2D(8, pad=pad), params, lambda p: p[0])
    want = jm.apply({"params": params}, jnp.asarray(x))
    got = _nhwc(tm(_nchw(x)))
    assert got.shape == want.shape
    assert max_abs(got, np.asarray(want)) < TOL


def test_upsample_equals_subpixel_form():
    """Nearest + conv against the JAX package's subpixel decomposition."""
    x = _x((2, 5, 4, 8))
    jm = jl.Upsample2D(8)
    params = _init(jm, jnp.asarray(x))
    tm = _carry(tl.Upsample2D(8), params, lambda p: p[0])
    want = jm.apply({"params": params}, jnp.asarray(x))
    got = _nhwc(tm(_nchw(x)))
    assert got.shape == want.shape == (2, 10, 8, 8)
    assert max_abs(got, np.asarray(want)) < TOL


def test_vae_attention():
    x = _x((1, 5, 6, 16))
    jm = jl.VAEAttention()
    params = _init(jm, jnp.asarray(x))
    namer = lambda p: "group_norm" if p[0] == "group_norm" else tconv._attention(p[1:])
    tm = _carry(tl.VAEAttention(16), params, namer)
    want = jm.apply({"params": params}, jnp.asarray(x))
    assert max_abs(_nhwc(tm(_nchw(x))), np.asarray(want)) < TOL


def test_channels_last_keeps_nhwc_view_free():
    """Inside the models tensors are channels_last: the NHWC view that the
    GroupNorm kernel takes is then contiguous, no copy."""
    block = tl.ResnetBlock2D(32, 32, None).to(memory_format=torch.channels_last)
    x = torch.randn(1, 32, 6, 6, generator=torch.Generator().manual_seed(0)) \
        .contiguous(memory_format=torch.channels_last)
    out = block(x)
    assert out.permute(0, 2, 3, 1).is_contiguous()
    assert block.norm1(x).permute(0, 2, 3, 1).is_contiguous()


def test_set_use_kernels_reaches_every_norm_and_attention():
    block = tl.Transformer2D(64, 2, 32, 16)
    tl.set_use_kernels(block, "off")
    flagged = [m for m in block.modules() if hasattr(m, "use_kernels")]
    assert len(flagged) == 1 + 3 + 2 and all(m.use_kernels == "off" for m in flagged)
    tl.set_use_kernels(block, "on")
    with pytest.raises(RuntimeError, match="CUDA tensor"):
        block(torch.zeros(1, 64, 4, 4), torch.zeros(1, 3, 16))
