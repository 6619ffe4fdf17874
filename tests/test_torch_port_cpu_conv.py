"""The port's convolutions on the CPU are as exact as the JAX package's.

Every library convolution of the port goes through ``models/layers.py``'s
``conv2d``, which on a CPU tensor convolves contiguous operands: oneDNN sums
an fp32 convolution of channels_last operands about 10x less exactly than a
contiguous one, and less exactly than XLA. Here the same numpy inputs
(x ~ N(0, 1), weights ~ N(0, 1) / sqrt(fan_in)) go through a convolution
site of the port, laid out as the port lays it out (channels_last
activations and weights, as ``load_bundle`` gives them), and through XLA's
convolution in the JAX package's layout (NHWC, HWIO); each is compared with
the same convolution in float64. Bar: the port's max abs error at most 2x
XLA's. Each case prints its errors (``CPU_CONV`` lines; ``pytest -s``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from elasticdiffusion_tpu.kernels.conv3x3 import \
    reference_conv3x3 as j_reference_conv3x3
from elasticdiffusion_tpu_torch.kernels import conv3x3 as tconv
from elasticdiffusion_tpu_torch.models import layers
from elasticdiffusion_tpu_torch.parallel import halo_decode as thd

RATIO = 2.0
CL = torch.channels_last


def _inputs(seed, C, H, W, O, k):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((1, C, H, W)).astype(np.float32)
    w = (rng.standard_normal((O, C, k, k))
         / np.sqrt(C * k * k)).astype(np.float32)
    b = (0.1 * rng.standard_normal(O)).astype(np.float32)
    return x, w, b


def _f64(x, w, b, stride=1, padding=0):
    return F.conv2d(torch.from_numpy(x).double(), torch.from_numpy(w).double(),
                    torch.from_numpy(b).double(), stride, padding).numpy()


def _xla(x, w, b, stride=1, padding=((0, 0), (0, 0))):
    """XLA's fp32 convolution in the JAX package's layout, back to NCHW."""
    out = jax.lax.conv_general_dilated(
        jnp.asarray(x.transpose(0, 2, 3, 1)), jnp.asarray(w.transpose(2, 3, 1, 0)),
        (stride, stride), padding, dimension_numbers=("NHWC", "HWIO", "NHWC"),
        precision=jax.lax.Precision.HIGHEST) + jnp.asarray(b)
    return np.asarray(out).transpose(0, 3, 1, 2)


def _module(module, w, b):
    """A port module with the weights, laid out as load_bundle lays it."""
    with torch.no_grad():
        module.weight.copy_(torch.from_numpy(w))
        module.bias.copy_(torch.from_numpy(b))
    return module.to(memory_format=CL).eval()


def _check(name, got, want64, xla):
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    assert got.shape == want64.shape == xla.shape
    err = float(np.abs(got - want64).max())
    err_xla = float(np.abs(xla - want64).max())
    print(f"CPU_CONV {name} port={err!r} xla={err_xla!r} "
          f"ratio={err / err_xla:.3f} bar={RATIO}")
    assert err <= RATIO * err_xla, (err, err_xla)


@pytest.mark.parametrize("C,H,W", [(512, 32, 64), (128, 256, 512)],
                         ids=["512x32x64", "128x256x512"])
def test_conv3x3_library_route(C, H, W):
    """``Conv3x3`` under conv_impl='cudnn' (the default): the library
    convolution of every VAE and default UNet 3x3."""
    x, w, b = _inputs(0, C, H, W, C, 3)
    conv = _module(layers.Conv3x3(C, C), w, b)
    with torch.no_grad():
        got = conv(torch.from_numpy(x).contiguous(memory_format=CL))
    assert got.is_contiguous(memory_format=CL)
    _check(f"conv3x3_{C}x{H}x{W}", got, _f64(x, w, b, padding=1),
           _xla(x, w, b, padding=((1, 1), (1, 1))))


def test_conv1x1_at_512_channels():
    """A 1x1 convolution: a Transformer2D's ``proj_in`` at 512 channels."""
    x, w, b = _inputs(1, 512, 32, 64, 512, 1)
    conv = _module(layers.Transformer2D(512, 8, 64, 768).proj_in, w, b)
    with torch.no_grad():
        got = conv(torch.from_numpy(x).contiguous(memory_format=CL))
    _check("conv1x1_512x32x64", got, _f64(x, w, b), _xla(x, w, b))


def test_downsample_stride_2():
    """The VAE's ``Downsample2D``: pad (0, 1) a side, 3x3 stride 2."""
    x, w, b = _inputs(2, 256, 64, 128, 256, 3)
    down = layers.Downsample2D(256, pad=(0, 1))
    _module(down.conv, w, b)
    with torch.no_grad():
        got = down(torch.from_numpy(x).contiguous(memory_format=CL))
    xp = np.pad(x, ((0, 0), (0, 0), (0, 1), (0, 1)))
    _check("downsample_256x64x128", got, _f64(xp, w, b, stride=2),
           _xla(xp, w, b, stride=2))


def test_halo_decode_window():
    """A window of rows of conv3x3(upsample_x2(x)) as the streamed halo
    decode reads it (``_upsample_read``): 24 rows from row 40."""
    x, w, b = _inputs(3, 256, 48, 96, 256, 3)
    conv = _module(layers.Conv3x3(256, 256), w, b)
    read = thd._upsample_read(torch.from_numpy(x).contiguous(memory_format=CL),
                              conv)
    with torch.no_grad():
        got = read(40, 24)
    up = x.repeat(2, axis=2).repeat(2, axis=3)
    rows = slice(40, 64)
    _check("halo_window_256x96x192", got, _f64(up, w, b, padding=1)[:, :, rows],
           _xla(up, w, b, padding=((1, 1), (1, 1)))[:, :, rows])


def test_plain_conv3x3():
    """The conv3x3 kernel's plain version (``conv_impl='kernel'`` on the
    CPU) against the JAX package's ``reference_conv3x3``, NHWC views of
    channels_last tensors as ``Conv3x3`` passes them."""
    x, w, b = _inputs(4, 512, 32, 64, 512, 3)
    xt = torch.from_numpy(x).contiguous(memory_format=CL)
    wt = torch.from_numpy(w).contiguous(memory_format=CL)
    got = tconv.reference_conv3x3(xt.permute(0, 2, 3, 1), wt.permute(2, 3, 1, 0),
                                  torch.from_numpy(b)).permute(0, 3, 1, 2)
    want = np.asarray(j_reference_conv3x3(
        jnp.asarray(x.transpose(0, 2, 3, 1)), jnp.asarray(w.transpose(2, 3, 1, 0)),
        jnp.asarray(b))).transpose(0, 3, 1, 2)
    _check("plain_conv3x3_512x32x64", got, _f64(x, w, b, padding=1), want)


@pytest.mark.parametrize("layout", ["channels_last", "contiguous"])
def test_conv2d_hands_back_the_caller_s_layout(layout):
    """The CPU rule: contiguous operands through oneDNN, the result in the
    layout torch gives the caller's operands, the call counted; values those of torch's batched
    contiguous convolution (oneDNN), and each image's result that of the
    image convolved alone (torch alone would send a small single image to
    another backend)."""
    x, w, b = _inputs(5, 16, 12, 20, 24, 3)
    x = np.concatenate([x, 0.5 * x[:, :, ::-1], x[:, :, :, ::-1]])
    fmt = CL if layout == "channels_last" else torch.contiguous_format
    xt = torch.from_numpy(x).contiguous(memory_format=fmt)
    wt = torch.from_numpy(w).contiguous(memory_format=fmt)
    before = layers.conv2d.cpu_calls
    got = layers.conv2d(xt, wt, torch.from_numpy(b), 1, 1)
    assert layers.conv2d.cpu_calls == before + 1
    assert got.is_contiguous(memory_format=fmt)
    want = F.conv2d(torch.from_numpy(x), torch.from_numpy(w),
                    torch.from_numpy(b), 1, 1)
    assert torch.equal(got, want)
    alone = torch.cat([layers.conv2d(xt[i:i + 1], wt, torch.from_numpy(b), 1, 1)
                       for i in range(3)])
    assert torch.equal(alone, got)


def test_row_linear_gives_each_row_its_own_product():
    """``RowLinear`` (the time embeddings' (batch, features) products): on
    the CPU each row's result is that of the row alone, whatever the batch;
    the parameters are ``nn.Linear``'s."""
    rng = np.random.default_rng(6)
    lin = layers.RowLinear(256, 64)
    assert isinstance(lin, torch.nn.Linear)
    assert set(dict(lin.named_parameters())) == {"weight", "bias"}
    x = torch.from_numpy(rng.standard_normal((8, 256)).astype(np.float32))
    with torch.no_grad():
        got = lin(x)
        alone = torch.cat([lin(x[i:i + 1]) for i in range(8)])
        halves = torch.cat([lin(x[:3]), lin(x[3:])])
        want = F.linear(x.double(), lin.weight.double(), lin.bias.double())
    assert torch.equal(got, alone) and torch.equal(got, halves)
    assert (got.double() - want).abs().max().item() < 1e-5
