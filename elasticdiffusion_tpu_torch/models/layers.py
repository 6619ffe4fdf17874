"""Shared building blocks of the SD model stack (UNet / VAE), as nn.Modules.

Counterparts of ``elasticdiffusion_tpu/models/layers.py`` with the same
numerical contracts: GroupNorm(32)+SiLU ResNet blocks, Transformer2D with a
GEGLU feed-forward, sinusoidal timestep embeddings, fp32 norm statistics and
fp32 softmax around matmuls in the compute dtype.

Layout: tensors between blocks are NCHW in the ``channels_last`` memory
format. cuDNN runs its fastest bf16 convolutions on that format, and the
NHWC view that the GroupNorm kernel and the transformer want
(``x.permute(0, 2, 3, 1)``) is then free: no copy at a norm, none at the
entry or exit of a Transformer2D.

Modules and parameters are named after the diffusers / HF checkpoint keys
(``to_out.0``, ``ff.net.0.proj``, ``transformer_blocks.{k}``), so a state dict
of a checkpoint loads by name.

Every norm and attention module carries ``use_kernels`` ('auto' | 'on' |
'off', see ``kernels/__init__.py``); ``set_use_kernels`` flips a whole model.
Every ``Conv3x3`` carries ``conv_impl`` ('cudnn' | 'kernel');
``set_conv_impl`` flips a whole model.

Every library convolution of the port goes through ``conv2d`` (``Conv2d``,
``ConvTranspose2d`` and ``Conv3x3``'s library route are ``nn`` modules
whose forward calls it). On a CPU tensor it convolves contiguous (NCHW)
operands, through oneDNN at every batch size, and hands the result back in
the caller's layout: oneDNN sums a channels_last fp32 convolution about 10x
less exactly than a contiguous one, and less exactly than XLA, the JAX
package's. On a CUDA tensor it is ``F.conv2d`` (cuDNN) as it stands.

On the CPU two ops give an image the same result whatever batch it came in
(a mesh rank runs a share of the batch): ``conv2d``, which takes oneDNN at
every batch size, and ``RowLinear``, the timestep embedding's and
``time_emb_proj``'s (batch, features) products computed row by row. The
attention and the linear projections of (B, N, C) tokens are not
batch-invariant.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.nn.modules.utils import _pair

from ..kernels import check_conv_impl
from ..kernels import conv3x3 as conv_kernel
from ..kernels.attention import dot_product_attention
from ..kernels.groupnorm import group_norm, reference_group_norm
from ..kernels.layernorm import layer_norm


def set_use_kernels(module: nn.Module, mode: str) -> None:
    """Set ``use_kernels`` on every norm and attention module below."""
    for m in module.modules():
        if hasattr(m, "use_kernels"):
            m.use_kernels = mode


def set_conv_impl(module: nn.Module, mode: str) -> None:
    """Set ``conv_impl`` on every ``Conv3x3`` below."""
    check_conv_impl(mode)
    for m in module.modules():
        if isinstance(m, Conv3x3):
            m.conv_impl = mode


def _like_channels_last(t: torch.Tensor) -> bool:
    """Whether torch takes a 4-D tensor for channels_last (its
    ``suggest_memory_format``): strides ordered C, W, H, N."""
    if t.dim() != 4 or t.stride(1) == 0:
        return False
    low = 0
    for d in (1, 3, 2, 0):
        if t.shape[d] == 0 or t.stride(d) < low or (
                d == 0 and low == t.stride(1)):
            return False
        low = t.stride(d) * max(t.shape[d], 1)
    return True


def _on_cpu(op, x: torch.Tensor, weight: torch.Tensor, *args):
    """The CPU rule: `op` on contiguous operands, the result in the layout
    torch gives the operands as they came (channels_last if either is)."""
    conv2d.cpu_calls += 1
    channels_last = _like_channels_last(x) or _like_channels_last(weight)
    # both operands contiguous: a channels_last weight alone would send the
    # convolution back to the inexact route
    y = op(x.contiguous(), weight.contiguous(), *args)
    return y.contiguous(memory_format=torch.channels_last) \
        if channels_last else y


def _onednn_conv2d(x, weight, bias, stride, padding, dilation, groups):
    """An fp32 convolution through oneDNN at every batch size. torch sends a
    small single image to another backend, whose sums differ from oneDNN's:
    an image's result would then depend on the batch it came in (a rank of
    a mesh runs a share of the batch)."""
    if x.dtype != torch.float32 or not torch.backends.mkldnn.is_available() \
            or not torch.backends.mkldnn.enabled:
        return F.conv2d(x, weight, bias, stride, padding, dilation, groups)
    return torch.mkldnn_convolution(x, weight, bias, _pair(padding),
                                    _pair(stride), _pair(dilation), groups)


def conv2d(x: torch.Tensor, weight: torch.Tensor,
           bias: Optional[torch.Tensor] = None, stride=1, padding=0,
           dilation=1, groups=1) -> torch.Tensor:
    """``F.conv2d``; on a CPU tensor on contiguous operands through oneDNN,
    the result in the layout ``F.conv2d`` gives these operands (see the
    module's docstring)."""
    if x.device.type != "cpu":
        return F.conv2d(x, weight, bias, stride, padding, dilation, groups)
    return _on_cpu(_onednn_conv2d, x, weight, bias, stride, padding,
                   dilation, groups)


# convolutions the CPU rule ran: 0 on a card path
conv2d.cpu_calls = 0


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` (same parameters and names) whose forward is
    ``conv2d``."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv2d(x, self.weight, self.bias, self.stride, self.padding,
                      self.dilation, self.groups)


class ConvTranspose2d(nn.ConvTranspose2d):
    """``nn.ConvTranspose2d`` (same parameters and names) under the CPU rule
    of ``conv2d``."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        args = (self.bias, self.stride, self.padding, self.output_padding,
                self.groups, self.dilation)
        if x.device.type != "cpu":
            return F.conv_transpose2d(x, self.weight, *args)
        return _on_cpu(F.conv_transpose2d, x, self.weight, *args)


class RowLinear(nn.Linear):
    """``nn.Linear`` (same parameters and names) for a (batch, features)
    input, which a mesh rank sees a share of: on the CPU each row is its own
    product, since BLAS sums a small product in an order that depends on its
    row count, and a row's result would depend on the batch it came in."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.device.type != "cpu" or x.dim() != 2 or x.shape[0] < 2:
            return super().forward(x)
        return torch.cat([F.linear(r, self.weight, self.bias)
                          for r in x.split(1)])


def timestep_embedding(timesteps: torch.Tensor, dim: int,
                       flip_sin_to_cos: bool = True,
                       downscale_freq_shift: float = 0.0,
                       max_period: int = 10000) -> torch.Tensor:
    """Sinusoidal embeddings, diffusers get_timestep_embedding semantics.
    timesteps: (B,) -> (B, dim) fp32."""
    half = dim // 2
    exponent = -math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=timesteps.device)
    exponent = exponent / (half - downscale_freq_shift)
    freqs = torch.exp(exponent)
    args = timesteps.float()[:, None] * freqs[None, :]
    sin, cos = torch.sin(args), torch.cos(args)
    emb = torch.cat([cos, sin] if flip_sin_to_cos else [sin, cos], dim=-1)
    if dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


def clamped_groups(channels: int, num_groups: int = 32) -> int:
    """Group count of GroupNorm32. Real SD channel counts divide by 32; tiny
    test configs fall back to gcd(C, 32) and keep the group size >= 4
    (single-channel groups cancel the resnet time-embedding bias exactly and
    size-2 groups amplify rounding noise by 1/sqrt(eps))."""
    groups = num_groups if channels % num_groups == 0 \
        else math.gcd(channels, num_groups)
    return max(1, min(groups, channels // 4))


class GroupNorm32(nn.Module):
    """GroupNorm over an NCHW tensor with fp32 statistics, output in the
    input dtype, optional fused SiLU.

    One rule: a 4-D input whose group count was not clamped takes the CUDA
    kernel on a CUDA tensor, in the UNet and in the VAE. Clamped groups
    (toy configs only) take the plain version.
    """

    def __init__(self, channels: int, num_groups: int = 32, eps: float = 1e-5,
                 silu: bool = False, use_kernels: str = "auto"):
        super().__init__()
        self.num_groups = num_groups
        self.groups = clamped_groups(channels, num_groups)
        self.eps = eps
        self.silu = silu
        self.use_kernels = use_kernels
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xh = x.permute(0, 2, 3, 1)  # NHWC; a view of a channels_last tensor
        if self.groups != self.num_groups:
            out = reference_group_norm(xh, self.weight, self.bias, self.groups,
                                       self.eps, self.silu)
        else:
            out = group_norm(xh, self.weight, self.bias, self.groups, self.eps,
                             self.silu, use_kernels=self.use_kernels)
        return out.permute(0, 3, 1, 2)


class LayerNorm32(nn.Module):
    """LayerNorm over the last dim with fp32 statistics, output in the input
    dtype. eps 1e-5 is the torch/diffusers default the checkpoints were
    trained with."""

    def __init__(self, channels: int, eps: float = 1e-5,
                 use_kernels: str = "auto"):
        super().__init__()
        self.eps = eps
        self.use_kernels = use_kernels
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.weight, self.bias, self.eps,
                          use_kernels=self.use_kernels)


class TimestepEmbedding(nn.Module):
    """Linear -> SiLU -> Linear (diffusers TimestepEmbedding)."""

    def __init__(self, in_dim: int, embed_dim: int):
        super().__init__()
        self.linear_1 = RowLinear(in_dim, embed_dim)
        self.linear_2 = RowLinear(embed_dim, embed_dim)

    def forward(self, t_emb: torch.Tensor) -> torch.Tensor:
        return self.linear_2(F.silu(self.linear_1(t_emb)))


class Conv3x3(Conv2d):
    """3x3 SAME stride-1 convolution; an ``nn.Conv2d`` in its parameters
    (``weight`` (O, C, 3, 3), ``bias``), so state dicts load unchanged.

    ``conv_impl`` is the counterpart of the JAX package's ``ED_CONV_IMPL``:
    'cudnn' (the default, as the JAX default is XLA's conv) runs
    ``conv2d``; 'kernel' sends an input inside the gate (4-D,
    ``C % 8 == 0`` and ``O % 8 == 0``) to the hand-written kernel on a CUDA
    tensor and to its plain version on a CPU tensor. Outside the gate
    (``conv_in`` with 4 input channels, ``conv_out`` with 4 output channels)
    both modes run ``conv2d``.

    The kernel reads the NHWC view of a ``channels_last`` input and the HWIO
    view of a ``channels_last`` weight in place. A weight in another layout
    is laid out once per module, not once per call.
    """

    def __init__(self, in_channels: int, out_channels: int,
                 conv_impl: str = "cudnn"):
        super().__init__(in_channels, out_channels, 3, padding=1)
        self.conv_impl = check_conv_impl(conv_impl)
        self._hwio = None  # ((weight version, data_ptr), its HWIO re-layout)
        # times conv2d ran on a CUDA tensor inside the gate
        self.library_cuda_calls = 0

    def in_gate(self, x: torch.Tensor) -> bool:
        return x.dim() == 4 and conv_kernel.in_gate(
            (x.shape[0], x.shape[2], x.shape[3], x.shape[1]),
            (3, 3, self.in_channels, self.out_channels))

    def _weight_hwio(self) -> torch.Tensor:
        """(3, 3, C, O) view of the weight with C contiguous."""
        w = self.weight
        if w.is_contiguous(memory_format=torch.channels_last):
            return w.permute(2, 3, 1, 0)
        key = (w._version, w.data_ptr())
        if self._hwio is None or self._hwio[0] != key:
            laid = w.detach().contiguous(memory_format=torch.channels_last)
            self._hwio = (key, laid.permute(2, 3, 1, 0))
        return self._hwio[1]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inside = self.in_gate(x)
        if check_conv_impl(self.conv_impl) == "kernel" and inside:
            xh = x.permute(0, 2, 3, 1)  # NHWC; a view of a channels_last tensor
            if x.is_cuda:  # launches or raises
                y = conv_kernel.conv3x3(xh, self._weight_hwio(), self.bias)
            else:
                y = conv_kernel.reference_conv3x3(
                    xh, self.weight.permute(2, 3, 1, 0), self.bias)
            return y.permute(0, 3, 1, 2)
        if inside and x.is_cuda:
            self.library_cuda_calls += 1
        return super().forward(x)


class ResnetBlock2D(nn.Module):
    """GN -> SiLU -> conv -> (+temb) -> GN -> SiLU -> conv -> +skip.

    norm_eps: 1e-5 for UNet resnets, 1e-6 for VAE resnets (diffusers
    resnet_eps convention).
    """

    def __init__(self, in_channels: int, out_channels: int,
                 temb_channels: Optional[int] = None, norm_eps: float = 1e-5,
                 use_kernels: str = "auto"):
        super().__init__()
        self.norm1 = GroupNorm32(in_channels, eps=norm_eps, silu=True,
                                 use_kernels=use_kernels)
        self.conv1 = Conv3x3(in_channels, out_channels)
        self.time_emb_proj = (RowLinear(temb_channels, out_channels)
                              if temb_channels is not None else None)
        self.norm2 = GroupNorm32(out_channels, eps=norm_eps, silu=True,
                                 use_kernels=use_kernels)
        self.conv2 = Conv3x3(out_channels, out_channels)
        self.conv_shortcut = (Conv2d(in_channels, out_channels, 1)
                              if in_channels != out_channels else None)

    def forward(self, x: torch.Tensor,
                temb: Optional[torch.Tensor] = None) -> torch.Tensor:
        h = self.conv1(self.norm1(x))
        if self.time_emb_proj is not None and temb is not None:
            h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(self.norm2(h))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class CrossAttention(nn.Module):
    """Multi-head attention; self-attention when context is None.
    qkv_bias=True only in the VAE mid-block attention."""

    def __init__(self, query_dim: int, context_dim: Optional[int],
                 num_heads: int, head_dim: int, qkv_bias: bool = False,
                 use_kernels: str = "auto"):
        super().__init__()
        inner = num_heads * head_dim
        ctx = query_dim if context_dim is None else context_dim
        self.num_heads, self.head_dim = num_heads, head_dim
        self.use_kernels = use_kernels
        self.to_q = nn.Linear(query_dim, inner, bias=qkv_bias)
        self.to_k = nn.Linear(ctx, inner, bias=qkv_bias)
        self.to_v = nn.Linear(ctx, inner, bias=qkv_bias)
        self.to_out = nn.ModuleList([nn.Linear(inner, query_dim)])

    def attend(self, x: torch.Tensor,
               context: Optional[torch.Tensor] = None) -> torch.Tensor:
        ctx = x if context is None else context
        B, Sq, Sk = x.shape[0], x.shape[1], ctx.shape[1]
        # (B, S, H*D) -> (B, S, H, D) is a view: the kernel reads it in place
        q = self.to_q(x).view(B, Sq, self.num_heads, self.head_dim)
        k = self.to_k(ctx).view(B, Sk, self.num_heads, self.head_dim)
        v = self.to_v(ctx).view(B, Sk, self.num_heads, self.head_dim)
        out = dot_product_attention(q, k, v, use_kernels=self.use_kernels)
        return self.to_out[0](out.reshape(B, Sq, -1))

    def forward(self, x, context=None):
        return self.attend(x, context)


class _GEGLU(nn.Module):
    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.proj = nn.Linear(dim, inner * 2)

    def forward(self, x):
        h, gate = self.proj(x).chunk(2, dim=-1)
        return h * F.gelu(gate)  # exact (erf) gelu


class GEGLUFeedForward(nn.Module):
    """proj to 2*4*dim, x * gelu(gate), proj back (diffusers FeedForward)."""

    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        # index 1 is the checkpoint's dropout slot
        self.net = nn.ModuleList([_GEGLU(dim, dim * mult), nn.Identity(),
                                  nn.Linear(dim * mult, dim)])

    def forward(self, x):
        return self.net[2](self.net[0](x))


class BasicTransformerBlock(nn.Module):
    """LN->self-attn, LN->cross-attn, LN->GEGLU FF, all residual."""

    def __init__(self, dim: int, num_heads: int, head_dim: int,
                 context_dim: int, use_kernels: str = "auto"):
        super().__init__()
        self.norm1 = LayerNorm32(dim, use_kernels=use_kernels)
        self.attn1 = CrossAttention(dim, None, num_heads, head_dim,
                                    use_kernels=use_kernels)
        self.norm2 = LayerNorm32(dim, use_kernels=use_kernels)
        self.attn2 = CrossAttention(dim, context_dim, num_heads, head_dim,
                                    use_kernels=use_kernels)
        self.norm3 = LayerNorm32(dim, use_kernels=use_kernels)
        self.ff = GEGLUFeedForward(dim)

    def forward(self, x, context):
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), context)
        return x + self.ff(self.norm3(x))


class Transformer2D(nn.Module):
    """Spatial transformer: GN -> proj_in -> blocks -> proj_out -> +residual."""

    def __init__(self, channels: int, num_heads: int, head_dim: int,
                 context_dim: int, depth: int = 1,
                 use_linear_projection: bool = False,
                 use_kernels: str = "auto"):
        super().__init__()
        self.use_linear_projection = use_linear_projection
        self.norm = GroupNorm32(channels, eps=1e-6, use_kernels=use_kernels)
        proj = (lambda: nn.Linear(channels, channels)) if use_linear_projection \
            else (lambda: Conv2d(channels, channels, 1))
        self.proj_in = proj()
        self.transformer_blocks = nn.ModuleList([
            BasicTransformerBlock(channels, num_heads, head_dim, context_dim,
                                  use_kernels=use_kernels)
            for _ in range(depth)])
        self.proj_out = proj()

    def forward(self, x, context):
        B, C, H, W = x.shape
        h = self.norm(x)
        if self.use_linear_projection:
            h = self.proj_in(h.permute(0, 2, 3, 1).reshape(B, H * W, C))
        else:
            h = self.proj_in(h).permute(0, 2, 3, 1).reshape(B, H * W, C)
        for block in self.transformer_blocks:
            h = block(h, context)
        if self.use_linear_projection:
            h = self.proj_out(h).reshape(B, H, W, C).permute(0, 3, 1, 2)
        else:
            h = self.proj_out(h.reshape(B, H, W, C).permute(0, 3, 1, 2))
        return h + x


class Downsample2D(nn.Module):
    """3x3 stride-2 conv; `pad` matches diffusers: UNet pads (1,1), the VAE
    (0,1) per axis."""

    def __init__(self, channels: int, pad: Tuple[int, int] = (1, 1)):
        super().__init__()
        self.pad = tuple(pad)
        self.conv = Conv2d(channels, channels, 3, stride=2, padding=0)

    def forward(self, x):
        p0, p1 = self.pad
        return self.conv(F.pad(x, (p0, p1, p0, p1)))


class Upsample2D(nn.Module):
    """Nearest 2x + 3x3 conv. (The JAX package's subpixel decomposition of
    this pair is a TPU FLOP trick, equal up to one cast.)"""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = Conv3x3(channels, channels)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


class VAEAttention(CrossAttention):
    """Single-head spatial self-attention of the VAE mid block (qkv bias).

    The kernel matters here more than anywhere: a decode at N x N pixels
    runs this at (N/8)^2 tokens with head dim 512, where materialized fp32
    logits grow with the fourth power of N."""

    def __init__(self, channels: int, use_kernels: str = "auto"):
        super().__init__(channels, None, num_heads=1, head_dim=channels,
                         qkv_bias=True, use_kernels=use_kernels)
        self.group_norm = GroupNorm32(channels, eps=1e-6,
                                      use_kernels=use_kernels)

    def forward(self, x):
        B, C, H, W = x.shape
        h = self.group_norm(x).permute(0, 2, 3, 1).reshape(B, H * W, C)
        out = self.attend(h)
        return x + out.reshape(B, H, W, C).permute(0, 3, 1, 2)
