"""Plain float32 PyTorch models of Stable Diffusion: the UNet
(``UNet2DConditionModel``), the ControlNet (``ControlNetModel``), the VAE
(``AutoencoderKL``) and the CLIP text encoders (``CLIPTextModel`` /
``CLIPTextModelWithProjection``), written from the published architectures
with the diffusers and transformers parameter names, so that one state dict
in those names feeds both this reference and the program under test.

No kernel, no cache, no batching trick: every product is ``F.linear``,
``F.conv2d`` or ``torch.matmul``, every norm ``F.group_norm`` /
``F.layer_norm``, computed in float32 with TF32 off (``Precision``). The
same modules compute the benchmark's control: ``Precision("fp8")`` rounds
the inputs of every product (weights once, activations at each call,
attention's q, k, v and probabilities) to float8 e4m3 with a per-tensor
scale, the step below bfloat16; ``Precision("tf32")`` lets the products run
in TF32, the step below float32 (on a CUDA device the tensor cores' TF32;
on the CPU, which has none, the same inputs rounded to TF32's 10-bit
mantissa). ``Precision("bf16")`` rounds the same
inputs to bfloat16: the scale of what bf16 rounding alone moves a result.

This package imports nothing of the program (``elasticdiffusion_tpu_torch``)
and nothing of JAX.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

FP8_MAX = 448.0  # largest finite float8_e4m3fn
# bytes of fp32 logits one attention block may hold
ATTN_BLOCK_BYTES = 1 << 30


def bf16_round(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(x.dtype)


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 x rounded to TF32 (10 mantissa bits), to nearest even, on
    the CPU; on a CUDA device x unchanged (the TF32 flags round there)."""
    if x.device.type != "cpu" or x.dtype != torch.float32:
        return x
    i = x.contiguous().view(torch.int32)
    i = (i + 0x0FFF + ((i >> 13) & 1)) & ~0x1FFF
    return i.view(torch.float32).view_as(x)


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 with one scale for the whole tensor (its
    largest magnitude maps to 448), returned in x's dtype."""
    scale = x.detach().abs().amax().float().clamp(min=1e-30) / FP8_MAX
    return ((x / scale).to(torch.float8_e4m3fn).to(x.dtype)) * scale


class Precision:
    """How the reference computes its products.

    'fp32': float32 with TF32 off (the reference). 'fp8' / 'bf16': the
    inputs of every product rounded by ``fp8_round`` / ``bf16_round`` (fp8:
    the control of a bfloat16 model). 'tf32': TF32 products in matmuls and
    cuDNN convolutions (the control of a float32 model), emulated on the
    CPU by ``tf32_round``. Use as a context
    manager around a forward: it sets and restores the TF32 flags."""

    MODES = ("fp32", "fp8", "bf16", "tf32")
    ROUND = {"fp8": fp8_round, "bf16": bf16_round, "tf32": tf32_round}

    def __init__(self, mode: str = "fp32"):
        if mode not in self.MODES:
            raise ValueError(f"precision must be one of {self.MODES}, got {mode!r}")
        self.mode = mode

    def act(self, x: torch.Tensor) -> torch.Tensor:
        rnd = self.ROUND.get(self.mode)
        return rnd(x) if rnd else x

    @torch.no_grad()
    def prepare(self, model: nn.Module) -> nn.Module:
        """Round the model's matrices and convolution kernels in place
        ('fp8', 'bf16'; 'tf32' on the CPU); embeddings, biases and norm
        parameters stay."""
        rnd = self.ROUND.get(self.mode)
        if rnd:
            for name, p in model.named_parameters():
                if p.dim() >= 2 and not name.startswith("text_model.embeddings."):
                    p.copy_(rnd(p))
        return model

    def __enter__(self):
        self._prev = (torch.backends.cuda.matmul.allow_tf32,
                      torch.backends.cudnn.allow_tf32)
        tf32 = self.mode == "tf32"
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.backends.cudnn.allow_tf32 = tf32
        return self

    def __exit__(self, *exc):
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self._prev


def _p(*shape) -> nn.Parameter:
    return nn.Parameter(torch.empty(*shape), requires_grad=False)


class Linear(nn.Module):
    def __init__(self, din: int, dout: int, bias: bool = True):
        super().__init__()
        self.weight = _p(dout, din)
        if bias:
            self.bias = _p(dout)
        else:
            self.register_parameter("bias", None)

    def forward(self, x, prec: Precision):
        return F.linear(prec.act(x), self.weight, self.bias)


class Conv(nn.Module):
    def __init__(self, cin: int, cout: int, k: int = 3, stride: int = 1,
                 padding: int = 1):
        super().__init__()
        self.weight = _p(cout, cin, k, k)
        self.bias = _p(cout)
        self.stride, self.padding = stride, padding

    def forward(self, x, prec: Precision):
        return F.conv2d(prec.act(x), self.weight, self.bias, self.stride,
                        self.padding)


def norm_groups(channels: int, num_groups: int = 32) -> int:
    """The group count of a GroupNorm: 32 where the channels divide by 32
    (every published width); for narrower test models gcd(C, 32), at least
    4 channels a group."""
    groups = num_groups if channels % num_groups == 0 \
        else math.gcd(channels, num_groups)
    return max(1, min(groups, channels // 4))


class GroupNorm(nn.Module):
    def __init__(self, channels: int, eps: float):
        super().__init__()
        self.weight, self.bias = _p(channels), _p(channels)
        self.groups, self.eps = norm_groups(channels), eps

    def forward(self, x):
        return F.group_norm(x, self.groups, self.weight, self.bias, self.eps)


class LayerNorm(nn.Module):
    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.weight, self.bias = _p(channels), _p(channels)
        self.eps = eps

    def forward(self, x):
        return F.layer_norm(x, x.shape[-1:], self.weight, self.bias, self.eps)


def attention(q, k, v, heads: int, prec: Precision, causal: bool = False):
    """softmax(q k^T / sqrt(d)) v over `heads` heads; q (B, Sq, C), k and v
    (B, Sk, C). The logits are formed in blocks of query rows."""
    B, Sq, C = q.shape
    Sk, D = k.shape[1], C // heads
    split = lambda t, S: prec.act(t).reshape(B, S, heads, D).transpose(1, 2)
    qh, kh, vh = split(q, Sq), split(k, Sk), split(v, Sk)
    out = torch.empty_like(qh)
    rows = max(1, ATTN_BLOCK_BYTES // (4 * B * heads * Sk))
    for lo in range(0, Sq, rows):
        hi = min(Sq, lo + rows)
        logits = torch.matmul(qh[:, :, lo:hi], kh.transpose(-1, -2)) / math.sqrt(D)
        if causal:
            mask = torch.ones(hi - lo, Sk, dtype=torch.bool,
                              device=q.device).tril(lo)
            logits = logits.masked_fill(~mask, float("-inf"))
        out[:, :, lo:hi] = torch.matmul(prec.act(logits.softmax(-1)), vh)
    return out.transpose(1, 2).reshape(B, Sq, C)


# ---------------------------------------------------------------------------
# UNet2DConditionModel
# ---------------------------------------------------------------------------


def timestep_embedding(t: torch.Tensor, dim: int, flip_sin_to_cos: bool,
                       shift: float, max_period: int = 10000) -> torch.Tensor:
    """diffusers ``get_timestep_embedding``: (N,) -> (N, dim)."""
    half = dim // 2
    exponent = -math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=t.device) / (half - shift)
    args = t.float()[:, None] * torch.exp(exponent)[None, :]
    sin, cos = torch.sin(args), torch.cos(args)
    return torch.cat([cos, sin] if flip_sin_to_cos else [sin, cos], dim=-1)


class TimestepEmbedding(nn.Module):
    def __init__(self, din: int, dim: int):
        super().__init__()
        self.linear_1, self.linear_2 = Linear(din, dim), Linear(dim, dim)

    def forward(self, x, prec):
        return self.linear_2(F.silu(self.linear_1(x, prec)), prec)


class Resnet(nn.Module):
    def __init__(self, cin: int, cout: int, temb: Optional[int], eps: float):
        super().__init__()
        self.norm1 = GroupNorm(cin, eps)
        self.conv1 = Conv(cin, cout)
        if temb:
            self.time_emb_proj = Linear(temb, cout)
        self.norm2 = GroupNorm(cout, eps)
        self.conv2 = Conv(cout, cout)
        if cin != cout:
            self.conv_shortcut = Conv(cin, cout, 1, padding=0)

    def forward(self, x, prec, temb=None):
        h = self.conv1(F.silu(self.norm1(x)), prec)
        if temb is not None:
            h = h + self.time_emb_proj(F.silu(temb), prec)[:, :, None, None]
        h = self.conv2(F.silu(self.norm2(h)), prec)
        skip = self.conv_shortcut(x, prec) if hasattr(self, "conv_shortcut") else x
        return skip + h


class Attention(nn.Module):
    def __init__(self, dim: int, heads: int, ctx_dim: Optional[int] = None,
                 bias: bool = False):
        super().__init__()
        self.heads = heads
        self.to_q = Linear(dim, dim, bias)
        self.to_k = Linear(ctx_dim or dim, dim, bias)
        self.to_v = Linear(ctx_dim or dim, dim, bias)
        self.to_out = nn.ModuleList([Linear(dim, dim)])

    def forward(self, x, prec, ctx=None):
        ctx = x if ctx is None else ctx
        out = attention(self.to_q(x, prec), self.to_k(ctx, prec),
                        self.to_v(ctx, prec), self.heads, prec)
        return self.to_out[0](out, prec)


class GEGLU(nn.Module):
    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.proj = Linear(dim, 2 * inner)

    def forward(self, x, prec):
        h, gate = self.proj(x, prec).chunk(2, dim=-1)
        return h * F.gelu(gate)


class FeedForward(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.net = nn.ModuleList([GEGLU(dim, 4 * dim), nn.Identity(),
                                  Linear(4 * dim, dim)])

    def forward(self, x, prec):
        return self.net[2](self.net[0](x, prec), prec)


class TransformerBlock(nn.Module):
    def __init__(self, dim: int, heads: int, ctx_dim: int):
        super().__init__()
        self.norm1, self.attn1 = LayerNorm(dim), Attention(dim, heads)
        self.norm2, self.attn2 = LayerNorm(dim), Attention(dim, heads, ctx_dim)
        self.norm3, self.ff = LayerNorm(dim), FeedForward(dim)

    def forward(self, x, ctx, prec):
        x = x + self.attn1(self.norm1(x), prec)
        x = x + self.attn2(self.norm2(x), prec, ctx)
        return x + self.ff(self.norm3(x), prec)


class Transformer2D(nn.Module):
    def __init__(self, ch: int, heads: int, ctx_dim: int, depth: int,
                 linear: bool):
        super().__init__()
        self.linear = linear
        self.norm = GroupNorm(ch, 1e-6)
        mk = (lambda: Linear(ch, ch)) if linear else (lambda: Conv(ch, ch, 1, padding=0))
        self.proj_in = mk()
        self.transformer_blocks = nn.ModuleList(
            [TransformerBlock(ch, heads, ctx_dim) for _ in range(depth)])
        self.proj_out = mk()

    def forward(self, x, ctx, prec):
        B, C, H, W = x.shape
        h = self.norm(x)
        if self.linear:
            h = self.proj_in(h.permute(0, 2, 3, 1).reshape(B, H * W, C), prec)
        else:
            h = self.proj_in(h, prec).permute(0, 2, 3, 1).reshape(B, H * W, C)
        for blk in self.transformer_blocks:
            h = blk(h, ctx, prec)
        if self.linear:
            h = self.proj_out(h, prec).reshape(B, H, W, C).permute(0, 3, 1, 2)
        else:
            h = self.proj_out(h.reshape(B, H, W, C).permute(0, 3, 1, 2), prec)
        return h + x


class Downsample(nn.Module):
    """Stride-2 3x3 convolution; the UNet pads (1, 1) per axis, the VAE
    encoder (0, 1)."""

    def __init__(self, ch: int, pad=(1, 1)):
        super().__init__()
        self.conv = Conv(ch, ch, 3, stride=2, padding=0)
        self.pad = tuple(pad)

    def forward(self, x, prec):
        p0, p1 = self.pad
        return self.conv(F.pad(x, (p0, p1, p0, p1)), prec)


class Upsample(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.conv = Conv(ch, ch)

    def forward(self, x, prec):
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"), prec)


class Block(nn.Module):
    """A named container, so that parameter names follow diffusers."""


def _arch(cfg: dict):
    """(block widths, attention per level, transformer depths, heads) of a
    diffusers UNet or ControlNet config."""
    bo = list(cfg["block_out_channels"])
    n = len(bo)
    has_attn = [t.startswith("CrossAttn") for t in cfg["down_block_types"]]
    depth = cfg.get("transformer_layers_per_block", 1)
    depth = [depth] * n if isinstance(depth, int) else list(depth)
    heads = cfg["attention_head_dim"]
    heads = [heads] * n if isinstance(heads, int) else list(heads)
    return bo, has_attn, depth, heads


def _t2d(cfg: dict, i: int) -> "Transformer2D":
    bo, _, depth, heads = _arch(cfg)
    return Transformer2D(bo[i], heads[i], cfg["cross_attention_dim"], depth[i],
                         cfg.get("use_linear_projection", False))


def _trunk(m: nn.Module, cfg: dict) -> list:
    """Registers on `m` the part of the UNet that a ControlNet copies, in
    the UNet's order: conv_in, time_embedding (and SDXL's add_embedding),
    down_blocks, mid_block. Returns the channels of the down path's skips."""
    bo, has_attn, _, _ = _arch(cfg)
    n = len(bo)
    temb = 4 * bo[0]
    lpb = cfg["layers_per_block"]
    m.conv_in = Conv(cfg["in_channels"], bo[0])
    m.time_embedding = TimestepEmbedding(bo[0], temb)
    if cfg.get("addition_embed_type") == "text_time":
        m.add_embedding = TimestepEmbedding(
            cfg["projection_class_embeddings_input_dim"], temb)
    m.down_blocks = nn.ModuleList()
    skips, ch = [bo[0]], bo[0]
    for i in range(n):
        blk = Block()
        blk.resnets = nn.ModuleList()
        if has_attn[i]:
            blk.attentions = nn.ModuleList()
        for _ in range(lpb):
            blk.resnets.append(Resnet(ch, bo[i], temb, 1e-5))
            if has_attn[i]:
                blk.attentions.append(_t2d(cfg, i))
            ch = bo[i]
            skips.append(ch)
        if i < n - 1:
            blk.downsamplers = nn.ModuleList([Downsample(ch)])
            skips.append(ch)
        m.down_blocks.append(blk)
    m.mid_block = Block()
    m.mid_block.resnets = nn.ModuleList(
        [Resnet(ch, ch, temb, 1e-5), Resnet(ch, ch, temb, 1e-5)])
    m.mid_block.attentions = nn.ModuleList([_t2d(cfg, n - 1)])
    return skips


def _embed(m: nn.Module, B: int, t, prec: Precision, add_text, add_tid, device):
    """The time embedding (plus SDXL's text_time one) of a batch of B."""
    cfg = m.cfg
    flip, shift = cfg.get("flip_sin_to_cos", True), cfg.get("freq_shift", 0)
    tt = torch.full((B,), float(t), device=device)
    emb = m.time_embedding(
        timestep_embedding(tt, m.conv_in.weight.shape[0], flip, shift), prec)
    if hasattr(m, "add_embedding"):
        tid = timestep_embedding(add_tid.reshape(-1),
                                 cfg["addition_time_embed_dim"], flip,
                                 shift).reshape(B, -1)
        emb = emb + m.add_embedding(torch.cat([add_text, tid], -1), prec)
    return emb


def _unet_down(m: nn.Module, h, emb, ctx, prec: Precision):
    """The down path from conv_in's output: (its output, every skip)."""
    res = [h]
    for blk in m.down_blocks:
        for j, r in enumerate(blk.resnets):
            h = r(h, prec, emb)
            if hasattr(blk, "attentions"):
                h = blk.attentions[j](h, ctx, prec)
            res.append(h)
        if hasattr(blk, "downsamplers"):
            h = blk.downsamplers[0](h, prec)
            res.append(h)
    return h, res


def _unet_mid(m: nn.Module, h, emb, ctx, prec: Precision):
    h = m.mid_block.resnets[0](h, prec, emb)
    h = m.mid_block.attentions[0](h, ctx, prec)
    return m.mid_block.resnets[1](h, prec, emb)


class UNet(nn.Module):
    """``UNet2DConditionModel`` from a diffusers ``unet/config.json``
    (``cfg``): SD 1.x / 2.x and SDXL ('text_time' conditioning)."""

    def __init__(self, cfg: dict):
        super().__init__()
        self.cfg = cfg
        bo, has_attn, _, _ = _arch(cfg)
        n = len(bo)
        temb = 4 * bo[0]
        skips = _trunk(self, cfg)
        ch = bo[-1]
        self.up_blocks = nn.ModuleList()
        for k in range(n):
            i = n - 1 - k
            blk = Block()
            blk.resnets = nn.ModuleList()
            if has_attn[i]:
                blk.attentions = nn.ModuleList()
            for _ in range(cfg["layers_per_block"] + 1):
                blk.resnets.append(Resnet(ch + skips.pop(), bo[i], temb, 1e-5))
                if has_attn[i]:
                    blk.attentions.append(_t2d(cfg, i))
                ch = bo[i]
            if i > 0:
                blk.upsamplers = nn.ModuleList([Upsample(ch)])
            self.up_blocks.append(blk)
        self.conv_norm_out = GroupNorm(bo[0], 1e-5)
        self.conv_out = Conv(bo[0], cfg["out_channels"])

    def forward(self, x, t, ctx, prec: Precision, add_text=None, add_tid=None,
                down_res=None, mid_res=None):
        """x (B, 4, h, w), t a float, ctx (B, 77, D) -> eps (B, 4, h, w).
        A ControlNet's residuals, where given, are added to the skips after
        the whole down path (`down_res`, one a skip) and to the mid block's
        output (`mid_res`), as diffusers adds them."""
        emb = _embed(self, x.shape[0], t, prec, add_text, add_tid, x.device)
        h, res = _unet_down(self, self.conv_in(x, prec), emb, ctx, prec)
        if down_res is not None:
            res = [r + a for r, a in zip(res, down_res, strict=True)]
        h = _unet_mid(self, h, emb, ctx, prec)
        if mid_res is not None:
            h = h + mid_res
        for blk in self.up_blocks:
            for j, r in enumerate(blk.resnets):
                h = r(torch.cat([h, res.pop()], dim=1), prec, emb)
                if hasattr(blk, "attentions"):
                    h = blk.attentions[j](h, ctx, prec)
            if hasattr(blk, "upsamplers"):
                h = blk.upsamplers[0](h, prec)
        return self.conv_out(F.silu(self.conv_norm_out(h)), prec)


# ---------------------------------------------------------------------------
# ControlNetModel
# ---------------------------------------------------------------------------


class ControlNet(nn.Module):
    """diffusers ``ControlNetModel`` from its ``config.json`` (``cfg``): a
    copy of the UNet's conv_in, embeddings, down path and mid block; the
    condition's embedding (a 3x3 conv, then per level a 3x3 conv and a
    stride-2 one, SiLU after each, and a last 3x3 conv to the UNet's first
    width), added to conv_in's output; a 1x1 "zero" convolution on each skip
    and on the mid block's output, each times the conditioning scale.
    RGB channel order, no global pooling, no guess mode."""

    def __init__(self, cfg: dict):
        super().__init__()
        self.cfg = cfg
        bo = list(cfg["block_out_channels"])
        skips = _trunk(self, cfg)
        ch = list(cfg["conditioning_embedding_out_channels"])
        emb = Block()
        emb.conv_in = Conv(cfg.get("conditioning_channels", 3), ch[0])
        emb.blocks = nn.ModuleList()
        for i in range(len(ch) - 1):
            emb.blocks.append(Conv(ch[i], ch[i]))
            emb.blocks.append(Conv(ch[i], ch[i + 1], stride=2))
        emb.conv_out = Conv(ch[-1], bo[0])
        self.controlnet_cond_embedding = emb
        self.controlnet_down_blocks = nn.ModuleList(
            [Conv(c, c, 1, padding=0) for c in skips])
        self.controlnet_mid_block = Conv(bo[-1], bo[-1], 1, padding=0)

    def forward(self, x, t, ctx, cond, scale: float, prec: Precision,
                add_text=None, add_tid=None):
        """x (B, 4, h, w), cond (B, 3, h * f, w * f) in [0, 1] -> (the
        down residuals, one a skip, the mid residual)."""
        emb = _embed(self, x.shape[0], t, prec, add_text, add_tid, x.device)
        ce = self.controlnet_cond_embedding
        c = F.silu(ce.conv_in(cond, prec))
        for blk in ce.blocks:
            c = F.silu(blk(c, prec))
        h = self.conv_in(x, prec) + ce.conv_out(c, prec)
        h, res = _unet_down(self, h, emb, ctx, prec)
        h = _unet_mid(self, h, emb, ctx, prec)
        down = [scale * z(r, prec) for z, r in zip(self.controlnet_down_blocks, res)]
        return down, scale * self.controlnet_mid_block(h, prec)


# ---------------------------------------------------------------------------
# AutoencoderKL
# ---------------------------------------------------------------------------


class VAEAttention(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.group_norm = GroupNorm(ch, 1e-6)
        self.to_q, self.to_k, self.to_v = Linear(ch, ch), Linear(ch, ch), Linear(ch, ch)
        self.to_out = nn.ModuleList([Linear(ch, ch)])

    def forward(self, x, prec):
        B, C, H, W = x.shape
        h = self.group_norm(x).permute(0, 2, 3, 1).reshape(B, H * W, C)
        out = attention(self.to_q(h, prec), self.to_k(h, prec),
                        self.to_v(h, prec), 1, prec)
        out = self.to_out[0](out, prec)
        return x + out.reshape(B, H, W, C).permute(0, 3, 1, 2)


def _mid(ch: int) -> Block:
    mid = Block()
    mid.resnets = nn.ModuleList([Resnet(ch, ch, None, 1e-6),
                                 Resnet(ch, ch, None, 1e-6)])
    mid.attentions = nn.ModuleList([VAEAttention(ch)])
    return mid


def _run_mid(mid: Block, h, prec):
    h = mid.resnets[0](h, prec)
    h = mid.attentions[0](h, prec)
    return mid.resnets[1](h, prec)


class VAE(nn.Module):
    """``AutoencoderKL`` from a diffusers ``vae/config.json`` (``cfg``)."""

    def __init__(self, cfg: dict):
        super().__init__()
        bo = list(cfg["block_out_channels"])
        lat = cfg["latent_channels"]
        lpb = cfg["layers_per_block"]
        enc = Block()
        enc.conv_in = Conv(cfg.get("in_channels", 3), bo[0])
        enc.down_blocks = nn.ModuleList()
        ch = bo[0]
        for i, out in enumerate(bo):
            blk = Block()
            blk.resnets = nn.ModuleList()
            for _ in range(lpb):
                blk.resnets.append(Resnet(ch, out, None, 1e-6))
                ch = out
            if i < len(bo) - 1:
                blk.downsamplers = nn.ModuleList([Downsample(ch, (0, 1))])
            enc.down_blocks.append(blk)
        enc.mid_block = _mid(ch)
        enc.conv_norm_out = GroupNorm(ch, 1e-6)
        enc.conv_out = Conv(ch, 2 * lat)
        self.encoder = enc
        self.quant_conv = Conv(2 * lat, 2 * lat, 1, padding=0)
        self.post_quant_conv = Conv(lat, lat, 1, padding=0)
        dec = Block()
        rbo = bo[::-1]
        dec.conv_in = Conv(lat, rbo[0])
        dec.mid_block = _mid(rbo[0])
        dec.up_blocks = nn.ModuleList()
        ch = rbo[0]
        for i, out in enumerate(rbo):
            blk = Block()
            blk.resnets = nn.ModuleList()
            for _ in range(lpb + 1):
                blk.resnets.append(Resnet(ch, out, None, 1e-6))
                ch = out
            if i < len(rbo) - 1:
                blk.upsamplers = nn.ModuleList([Upsample(ch)])
            dec.up_blocks.append(blk)
        dec.conv_norm_out = GroupNorm(ch, 1e-6)
        dec.conv_out = Conv(ch, cfg.get("out_channels", 3))
        self.decoder = dec

    def decode(self, z, prec: Precision):
        """(B, 4, h, w), already divided by the scaling factor -> (B, 3, 8h,
        8w) in [-1, 1] (unclamped)."""
        dec = self.decoder
        h = _run_mid(dec.mid_block, dec.conv_in(self.post_quant_conv(z, prec), prec), prec)
        for blk in dec.up_blocks:
            for r in blk.resnets:
                h = r(h, prec)
            if hasattr(blk, "upsamplers"):
                h = blk.upsamplers[0](h, prec)
        return dec.conv_out(F.silu(dec.conv_norm_out(h)), prec)

    def encode_sample(self, x, noise, prec: Precision):
        """Images in [-1, 1] -> mean + exp(logvar / 2) * noise."""
        enc = self.encoder
        h = enc.conv_in(x, prec)
        for blk in enc.down_blocks:
            for r in blk.resnets:
                h = r(h, prec)
            if hasattr(blk, "downsamplers"):
                h = blk.downsamplers[0](h, prec)
        h = _run_mid(enc.mid_block, h, prec)
        moments = self.quant_conv(enc.conv_out(F.silu(enc.conv_norm_out(h)), prec), prec)
        mean, logvar = moments.chunk(2, dim=1)
        return mean + torch.exp(0.5 * logvar.clamp(-30.0, 20.0)) * noise


# ---------------------------------------------------------------------------
# CLIP text encoders
# ---------------------------------------------------------------------------


class CLIPLayer(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        C = cfg["hidden_size"]
        self.heads = cfg["num_attention_heads"]
        self.act = cfg["hidden_act"]
        eps = cfg.get("layer_norm_eps", 1e-5)
        self.layer_norm1, self.layer_norm2 = LayerNorm(C, eps), LayerNorm(C, eps)
        sa = Block()
        sa.q_proj, sa.k_proj, sa.v_proj, sa.out_proj = (
            Linear(C, C), Linear(C, C), Linear(C, C), Linear(C, C))
        self.self_attn = sa
        mlp = Block()
        mlp.fc1 = Linear(C, cfg["intermediate_size"])
        mlp.fc2 = Linear(cfg["intermediate_size"], C)
        self.mlp = mlp

    def forward(self, x, prec):
        sa, mlp = self.self_attn, self.mlp
        h = self.layer_norm1(x)
        a = attention(sa.q_proj(h, prec), sa.k_proj(h, prec), sa.v_proj(h, prec),
                      self.heads, prec, causal=True)
        x = x + sa.out_proj(a, prec)
        h = mlp.fc1(self.layer_norm2(x), prec)
        h = h * torch.sigmoid(1.702 * h) if self.act == "quick_gelu" else F.gelu(h)
        return x + mlp.fc2(h, prec)


class CLIPText(nn.Module):
    """transformers ``CLIPTextModel`` (with ``text_projection`` when the
    config has ``projection_dim``) from its ``config.json`` (``cfg``)."""

    def __init__(self, cfg: dict, projection: bool):
        super().__init__()
        C = cfg["hidden_size"]
        tm = Block()
        tm.embeddings = Block()
        tm.embeddings.token_embedding = Block()
        tm.embeddings.token_embedding.weight = _p(cfg["vocab_size"], C)
        tm.embeddings.position_embedding = Block()
        tm.embeddings.position_embedding.weight = _p(cfg["max_position_embeddings"], C)
        tm.encoder = Block()
        tm.encoder.layers = nn.ModuleList(
            [CLIPLayer(cfg) for _ in range(cfg["num_hidden_layers"])])
        tm.final_layer_norm = LayerNorm(C, cfg.get("layer_norm_eps", 1e-5))
        self.text_model = tm
        if projection:
            self.text_projection = Linear(C, cfg["projection_dim"], bias=False)

    def forward(self, ids: torch.Tensor, prec: Precision):
        """ids (B, S) -> (last hidden state after the final LayerNorm, the
        input of the last layer, the pooled feature at the first occurrence
        of the highest id (the EOS), projected when the model has a
        projection)."""
        tm = self.text_model
        ids = ids.long()
        B, S = ids.shape
        x = tm.embeddings.token_embedding.weight[ids] \
            + tm.embeddings.position_embedding.weight[None, :S]
        layers = tm.encoder.layers
        pen = x
        for i, layer in enumerate(layers):
            if i == len(layers) - 1:
                pen = x
            x = layer(x, prec)
        last = tm.final_layer_norm(x)
        pooled = last[torch.arange(B, device=ids.device), ids.argmax(-1)]
        if hasattr(self, "text_projection"):
            pooled = self.text_projection(pooled, prec)
        return last, pen, pooled


def has_projection(cfg: dict) -> bool:
    """Whether a text encoder's config is a ``CLIPTextModelWithProjection``."""
    return cfg["architectures"][0] == "CLIPTextModelWithProjection"


def build(kind: str, cfg: dict) -> nn.Module:
    """A model of `kind` ('unet' | 'controlnet' | 'vae' | 'clip') with its parameters on
    the meta device: its ``state_dict()`` names and shapes are the
    checkpoint's."""
    with torch.device("meta"):
        if kind == "unet":
            return UNet(cfg)
        if kind == "controlnet":
            return ControlNet(cfg)
        if kind == "vae":
            return VAE(cfg)
        if kind == "clip":
            return CLIPText(cfg, has_projection(cfg))
    raise ValueError(kind)


def materialise(model: nn.Module, sd: dict, device, prec: Precision) -> nn.Module:
    """`model` (on the meta device) holding float32 copies of `sd`, rounded
    as `prec` asks."""
    state = {k: v.to(device=device, dtype=torch.float32, copy=True)
             for k, v in sd.items()}
    model.load_state_dict(state, strict=True, assign=True)
    return prec.prepare(model.eval())


def unet_rows(unet: UNet, x, t, ctx, prec: Precision, add_text=None,
              add_tid=None, rows: int = 4) -> torch.Tensor:
    """The UNet over a batch, `rows` rows at a time."""
    outs = []
    for lo in range(0, x.shape[0], rows):
        sl = slice(lo, lo + rows)
        outs.append(unet(x[sl], t, ctx[sl], prec,
                         None if add_text is None else add_text[sl],
                         None if add_tid is None else add_tid[sl]))
    return torch.cat(outs)

