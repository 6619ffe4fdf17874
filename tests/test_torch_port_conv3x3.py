"""The port's 3x3 convolution: its plain version against the JAX package's
Pallas kernel (interpret mode) and plain version, the ``Conv3x3`` module
wiring against the JAX module under ``ED_CONV_IMPL=pallas``, and the gate.

On the CPU ``conv_impl='kernel'`` runs the kernel's plain version, and only
because the tensor lies on the CPU. Same numpy inputs on both sides; the
weight is carried HWIO -> OIHW for the module tests.
"""

import flax.linen as jnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as nn
import torch.nn.functional as F

from elasticdiffusion_tpu.kernels.conv3x3 import (
    conv3x3 as j_conv3x3, reference_conv3x3 as j_reference_conv3x3)
from elasticdiffusion_tpu.models.layers import (
    Conv3x3 as JConv3x3, ResnetBlock2D as JResnetBlock2D)

from elasticdiffusion_tpu_torch import configs as tcfg
from elasticdiffusion_tpu_torch.kernels import conv3x3 as tconv
from elasticdiffusion_tpu_torch.models import layers as tl
from elasticdiffusion_tpu_torch.models.convert import unet_from_jax
from torch_port_common import max_abs, t2n, to_numpy_tree

# fp32 on both sides; the sums over 9*C products run in another order
CONV_TOL = 1e-5


def _operands(seed, B, H, W, C, O):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, H, W, C)).astype(np.float32),
            (rng.standard_normal((3, 3, C, O)) * 0.05).astype(np.float32),
            (rng.standard_normal((O,)) * 0.1).astype(np.float32))


# the shapes of tests/test_kernels.py, and a ragged one the TPU kernel's
# layout gate refuses (H, W not multiples of 8): there the JAX plain version
@pytest.mark.parametrize("B,H,W,C,O,pallas", [
    (2, 16, 16, 64, 64, True),
    (1, 32, 8, 64, 64, True),
    (1, 8, 8, 96, 32, True),
    (2, 16, 16, 64, 128, True),
    (2, 6, 10, 24, 40, False),
])
@pytest.mark.parametrize("bias", [False, True], ids=["nobias", "bias"])
@pytest.mark.parametrize("silu", [False, True], ids=["linear", "silu"])
def test_reference_conv3x3_matches_jax_kernel(B, H, W, C, O, pallas, bias, silu):
    x, w, b = _operands(0, B, H, W, C, O)
    jb = jnp.asarray(b) if bias else None
    got = t2n(tconv.reference_conv3x3(
        torch.from_numpy(x), torch.from_numpy(w),
        torch.from_numpy(b) if bias else None, silu_out=silu))
    assert got.shape == (B, H, W, O)
    plain = j_reference_conv3x3(jnp.asarray(x), jnp.asarray(w), jb, silu_out=silu)
    assert max_abs(got, np.asarray(plain)) < CONV_TOL
    if pallas:
        kernel = j_conv3x3(jnp.asarray(x), jnp.asarray(w), jb, silu_out=silu,
                           interpret=True)
        assert max_abs(got, np.asarray(kernel)) < CONV_TOL


def test_reference_conv3x3_bf16_contract():
    """bf16 operands, fp32 accumulation over the 9*320 products, one
    rounding to bf16: the bar of tests/test_kernels.py::test_conv3x3_bf16."""
    x, w, _ = _operands(1, 1, 16, 16, 320, 320)
    tx, tw = torch.from_numpy(x).bfloat16(), torch.from_numpy(w).bfloat16()
    got = tconv.reference_conv3x3(tx, tw)
    assert got.dtype == torch.bfloat16
    want = j_conv3x3(jnp.asarray(x).astype(jnp.bfloat16),
                     jnp.asarray(w).astype(jnp.bfloat16), interpret=True)
    np.testing.assert_allclose(t2n(got.float()),
                               np.asarray(want.astype(jnp.float32)),
                               atol=5e-2, rtol=5e-2)


def test_reference_conv3x3_takes_strided_views():
    """The views the module hands over (NHWC of a channels_last activation,
    HWIO of a channels_last weight) give the numbers of contiguous copies."""
    x, w, b = _operands(2, 1, 8, 8, 16, 8)
    x_cl = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)
    w_cl = torch.from_numpy(w).permute(3, 2, 0, 1).contiguous(
        memory_format=torch.channels_last)
    xv, wv = x_cl.permute(0, 2, 3, 1), w_cl.permute(2, 3, 1, 0)
    assert xv.stride(3) == 1 and wv.stride(2) == 1  # C contiguous in both
    got = tconv.reference_conv3x3(xv, wv, torch.from_numpy(b))
    want = tconv.reference_conv3x3(*map(torch.from_numpy, (x, w, b)))
    assert torch.equal(got, want)


@pytest.mark.parametrize("C,O", [(64, 64), (16, 40)])
def test_conv3x3_module_kernel_matches_cudnn_and_jax(C, O, monkeypatch):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((1, 16, 16, C)).astype(np.float32)
    jmod = JConv3x3(O, use_pallas="on")
    params = jmod.init(jax.random.PRNGKey(6), jnp.asarray(x))
    tree = to_numpy_tree(params["params"])
    tree["bias"] = (rng.standard_normal(O) * 0.1).astype(np.float32)

    tmod = tl.Conv3x3(C, O)
    assert isinstance(tmod, nn.Conv2d) and set(tmod.state_dict()) == {"weight", "bias"}
    tmod.load_state_dict({"weight": torch.tensor(tree["kernel"].transpose(3, 2, 0, 1)),
                          "bias": torch.tensor(tree["bias"])})
    tx = torch.from_numpy(x).permute(0, 3, 1, 2)
    with torch.no_grad():
        cudnn = tmod(tx)
        tmod.conv_impl = "kernel"
        kernel = tmod(tx)
    assert tmod.in_gate(tx) and kernel.shape == cudnn.shape == (1, O, 16, 16)
    assert max_abs(t2n(kernel), t2n(cudnn)) < CONV_TOL
    # the variable is read at trace time: a fresh module after setting it
    monkeypatch.setenv("ED_CONV_IMPL", "pallas")
    want = JConv3x3(O, use_pallas="on").apply({"params": tree}, jnp.asarray(x))
    assert max_abs(t2n(kernel.permute(0, 2, 3, 1)), np.asarray(want)) < CONV_TOL


def test_resnet_block_kernel_matches_cudnn_and_jax(monkeypatch):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 8, 8, 32)).astype(np.float32)
    temb = rng.standard_normal((2, 24)).astype(np.float32)
    jmod = JResnetBlock2D(64, use_pallas="on")
    params = jmod.init(jax.random.PRNGKey(7), jnp.asarray(x), jnp.asarray(temb))
    tree = to_numpy_tree(params["params"])
    # unet_from_jax names: wrap the block as the UNet's first mid resnet
    state = {k.split("mid_block.resnets.0.", 1)[1]: v for k, v in
             unet_from_jax({"mid_resnet_0": tree, "down_0_0": {}}).items()}
    tmod = tl.ResnetBlock2D(32, 64, 24)
    tmod.load_state_dict(state)
    tx = torch.from_numpy(x).permute(0, 3, 1, 2)
    with torch.no_grad():
        cudnn = tmod(tx, torch.from_numpy(temb))
        tl.set_conv_impl(tmod, "kernel")
        assert tmod.conv1.conv_impl == tmod.conv2.conv_impl == "kernel"
        kernel = tmod(tx, torch.from_numpy(temb))
    assert max_abs(t2n(kernel), t2n(cudnn)) < CONV_TOL
    monkeypatch.setenv("ED_CONV_IMPL", "pallas")
    want = JResnetBlock2D(64, use_pallas="on").apply(
        {"params": tree}, jnp.asarray(x), jnp.asarray(temb))
    assert max_abs(t2n(kernel.permute(0, 2, 3, 1)), np.asarray(want)) < 3e-5


def test_conv3x3_weight_in_another_layout_is_laid_out_once():
    mod = tl.Conv3x3(16, 8, conv_impl="kernel")
    assert not mod.weight.is_contiguous(memory_format=torch.channels_last)
    a, b = mod._weight_hwio(), mod._weight_hwio()
    assert a is b and a.shape == (3, 3, 16, 8) and a.stride(2) == 1
    with torch.no_grad():
        mod.weight.mul_(2.0)  # an in-place update invalidates the copy
    c = mod._weight_hwio()
    assert c is not a and torch.equal(c, mod.weight.permute(2, 3, 1, 0))
    mod = mod.to(memory_format=torch.channels_last)
    v = mod._weight_hwio()  # a view, no copy
    assert v.data_ptr() == mod.weight.data_ptr()


@pytest.mark.parametrize("what", ["conv_in", "conv_out", "stride2", "1x1",
                                  "3d_input"])
def test_gate_leaves_the_rest_to_conv2d(what):
    """conv_in (C=4) and conv_out (O=4) are outside the gate; stride-2 and
    1x1 convolutions are not Conv3x3 modules at all (the library
    ``Conv2d``)."""
    from elasticdiffusion_tpu_torch.models.unet import UNet2DCondition
    with torch.device("meta"):
        unet = UNet2DCondition(tcfg.UNET_SD1)
    tl.set_conv_impl(unet, "kernel")
    x4 = torch.zeros(1, 4, 8, 8)
    if what == "conv_in":
        assert isinstance(unet.conv_in, tl.Conv3x3) and not unet.conv_in.in_gate(x4)
        assert not tconv.in_gate((1, 8, 8, 4), (3, 3, 4, 320))
    elif what == "conv_out":
        assert not unet.conv_out.in_gate(torch.zeros(1, 320, 8, 8))
        assert not tconv.in_gate((1, 8, 8, 320), (3, 3, 320, 4))
    elif what == "stride2":
        conv = unet.down_blocks[0].downsamplers[0].conv
        assert type(conv) is tl.Conv2d and conv.stride == (2, 2)
    elif what == "1x1":
        conv = unet.down_blocks[1].resnets[0].conv_shortcut
        assert type(conv) is tl.Conv2d and conv.kernel_size == (1, 1)
        assert not tconv.in_gate((1, 8, 8, 320), (1, 1, 320, 640))
    else:
        assert not tl.Conv3x3(8, 8).in_gate(torch.zeros(8, 4, 4))
    # inside the gate: the resnet and upsample convolutions of the UNet
    inside = [m for m in unet.modules() if isinstance(m, tl.Conv3x3)
              and tconv.in_gate((1, 8, 8, m.in_channels),
                                (3, 3, m.in_channels, m.out_channels))]
    assert len(inside) == 2 * 22 + 3  # 22 resnets, 3 upsamplers


def test_outside_the_gate_kernel_mode_runs_conv2d(monkeypatch):
    """Outside the gate kernel mode takes the library route: the plain
    conv3x3 never runs, the result is ``conv2d``'s, and it agrees with
    ``F.conv2d`` on the same contiguous operands."""
    def plain(*args):
        raise AssertionError("the plain conv3x3 ran outside the gate")
    monkeypatch.setattr(tconv, "reference_conv3x3", plain)
    mod = tl.Conv3x3(4, 16, conv_impl="kernel")
    x = torch.randn(1, 4, 6, 6, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        got = mod(x)
        assert torch.equal(got, tl.conv2d(x, mod.weight, mod.bias,
                                          mod.stride, mod.padding))
        want = F.conv2d(x, mod.weight, mod.bias, mod.stride, mod.padding)
    assert max_abs(got, want) <= CONV_TOL


def test_conv_impl_validation():
    with pytest.raises(ValueError, match="conv_impl"):
        tcfg.RuntimeConfig(conv_impl="pallas")
    with pytest.raises(ValueError, match="conv_impl"):
        tl.Conv3x3(8, 8, conv_impl="fast")
    with pytest.raises(ValueError, match="conv_impl"):
        tl.set_conv_impl(tl.Conv3x3(8, 8), "on")
    mod = tl.Conv3x3(8, 8)
    mod.conv_impl = "sometimes"
    with pytest.raises(ValueError, match="conv_impl"):
        mod(torch.zeros(1, 8, 4, 4))
    assert tcfg.RuntimeConfig().conv_impl == "cudnn"
    assert tcfg.RuntimeConfig(conv_impl="kernel").conv_impl == "kernel"


def test_conv3x3_wrapper_refuses_cpu_tensors():
    """The kernel wrapper never computes on the CPU: it launches or raises."""
    before = tconv.conv3x3.launches
    with pytest.raises(RuntimeError, match="CUDA"):
        tconv.conv3x3(torch.zeros(1, 4, 4, 8), torch.zeros(3, 3, 8, 8))
    assert tconv.conv3x3.launches == before


def test_load_bundle_applies_conv_impl_to_the_unet_only():
    from toy_configs import toy_bundle_config
    from elasticdiffusion_tpu_torch.models.registry import load_bundle
    from torch_port_common import port_bundle_config
    rt = tcfg.RuntimeConfig(param_dtype=torch.float32,
                            compute_dtype=torch.float32, conv_impl="kernel")
    b = load_bundle("toy", rt, bundle_config=port_bundle_config(toy_bundle_config()),
                    device="cpu")
    convs = lambda m: [c for c in m.modules() if isinstance(c, tl.Conv3x3)]
    assert convs(b.unet) and all(c.conv_impl == "kernel" for c in convs(b.unet))
    assert convs(b.vae) and all(c.conv_impl == "cudnn" for c in convs(b.vae))
    b.set_conv_impl("cudnn")
    assert all(c.conv_impl == "cudnn" for c in convs(b.unet))
    # on a channels_last UNet the kernel's weight view is free
    w = b.unet.mid_block.resnets[0].conv1
    assert w._weight_hwio().data_ptr() == w.weight.data_ptr()
