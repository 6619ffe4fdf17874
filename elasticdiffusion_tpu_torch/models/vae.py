"""AutoencoderKL (encoder, decoder, quant convs).

Counterpart of ``elasticdiffusion_tpu/models/vae.py``: encode returns a
diagonal-Gaussian latent distribution that the caller samples with its own
noise; decode maps latents back to [-1, 1] RGB; ``scaling_factor`` is applied
by the pipeline. The decoder runs in two stages, as the JAX package's
does: stage a (``conv_in`` and the mid block, which holds the one global
attention) at latent resolution, stage b (the up blocks, ``conv_norm_out``,
SiLU and ``conv_out``: convolutions and GroupNorms only) for the 8x
upsampling. ``parallel/halo_decode.py`` decodes large images from the
split.

NCHW at the public boundary, ``channels_last`` inside (see
``models/layers.py``). Module names follow the diffusers checkpoint.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ..configs import VAEConfig
from .layers import (Conv2d, Conv3x3, Downsample2D, GroupNorm32,
                     ResnetBlock2D, Upsample2D, VAEAttention)


class _Block(nn.Module):
    def __init__(self):
        super().__init__()
        self.resnets = nn.ModuleList()


def _mid_block(ch: int, uk: str) -> nn.Module:
    mid = _Block()
    mid.resnets.append(ResnetBlock2D(ch, ch, norm_eps=1e-6, use_kernels=uk))
    mid.attentions = nn.ModuleList([VAEAttention(ch, use_kernels=uk)])
    mid.resnets.append(ResnetBlock2D(ch, ch, norm_eps=1e-6, use_kernels=uk))
    return mid


def _run_mid(mid: nn.Module, x: torch.Tensor) -> torch.Tensor:
    x = mid.resnets[0](x)
    x = mid.attentions[0](x)
    return mid.resnets[1](x)


class Encoder(nn.Module):
    def __init__(self, config: VAEConfig, use_kernels: str = "auto"):
        super().__init__()
        bo = config.block_out_channels
        self.conv_in = Conv3x3(config.in_channels, bo[0])
        self.down_blocks = nn.ModuleList()
        ch = bo[0]
        for i, out_ch in enumerate(bo):
            blk = _Block()
            for _ in range(config.layers_per_block):
                blk.resnets.append(ResnetBlock2D(ch, out_ch, norm_eps=1e-6,
                                                 use_kernels=use_kernels))
                ch = out_ch
            if i < len(bo) - 1:
                # the VAE downsample pads (0, 1) per axis (diffusers Encoder)
                blk.downsamplers = nn.ModuleList([Downsample2D(ch, pad=(0, 1))])
            self.down_blocks.append(blk)
        self.mid_block = _mid_block(ch, use_kernels)
        self.conv_norm_out = GroupNorm32(ch, eps=1e-6, silu=True,
                                         use_kernels=use_kernels)
        self.conv_out = Conv3x3(ch, 2 * config.latent_channels)

    def forward(self, x):
        x = self.conv_in(x)
        for blk in self.down_blocks:
            for resnet in blk.resnets:
                x = resnet(x)
            if hasattr(blk, "downsamplers"):
                x = blk.downsamplers[0](x)
        x = _run_mid(self.mid_block, x)
        return self.conv_out(self.conv_norm_out(x))


class Decoder(nn.Module):
    def __init__(self, config: VAEConfig, use_kernels: str = "auto"):
        super().__init__()
        bo = list(reversed(config.block_out_channels))
        self.conv_in = Conv3x3(config.latent_channels, bo[0])
        self.mid_block = _mid_block(bo[0], use_kernels)
        self.up_blocks = nn.ModuleList()
        ch = bo[0]
        for i, out_ch in enumerate(bo):
            blk = _Block()
            for _ in range(config.layers_per_block + 1):
                blk.resnets.append(ResnetBlock2D(ch, out_ch, norm_eps=1e-6,
                                                 use_kernels=use_kernels))
                ch = out_ch
            if i < len(bo) - 1:
                blk.upsamplers = nn.ModuleList([Upsample2D(ch)])
            self.up_blocks.append(blk)
        self.conv_norm_out = GroupNorm32(ch, eps=1e-6, silu=True,
                                         use_kernels=use_kernels)
        self.conv_out = Conv3x3(ch, config.out_channels)

    def stage_a(self, z):
        return _run_mid(self.mid_block, self.conv_in(z))

    def stage_b(self, x):
        for blk in self.up_blocks:
            for resnet in blk.resnets:
                x = resnet(x)
            if hasattr(blk, "upsamplers"):
                x = blk.upsamplers[0](x)
        return self.conv_out(self.conv_norm_out(x))

    def forward(self, z):
        return self.stage_b(self.stage_a(z))


class AutoencoderKL(nn.Module):
    def __init__(self, config: VAEConfig, use_kernels: str = "auto"):
        super().__init__()
        self.config = config
        self.encoder = Encoder(config, use_kernels)
        self.decoder = Decoder(config, use_kernels)
        self.quant_conv = Conv2d(2 * config.latent_channels,
                                 2 * config.latent_channels, 1)
        self.post_quant_conv = Conv2d(config.latent_channels,
                                      config.latent_channels, 1)

    @property
    def dtype(self) -> torch.dtype:
        return self.quant_conv.weight.dtype

    def _entry(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self.dtype).contiguous(memory_format=torch.channels_last)

    def encode_moments(self, images_nchw):
        """(B,3,H,W) in [-1,1] -> (mean, logvar), each (B,4,H/8,W/8)."""
        moments = self.quant_conv(self.encoder(self._entry(images_nchw)))
        mean, logvar = moments.chunk(2, dim=1)
        return mean, logvar.clamp(-30.0, 20.0)

    def encode_sample(self, images_nchw, noise):
        """Sample the latent distribution with noise supplied by the caller
        (the counterpart of latent_dist.sample(), injectable for parity)."""
        mean, logvar = self.encode_moments(images_nchw)
        std = torch.exp(0.5 * logvar.float())
        return (mean.float() + std * noise).contiguous()

    def decode(self, latents_nchw):
        """(B,4,h,w) (already divided by scaling_factor) -> (B,3,8h,8w) in
        [-1,1]."""
        return self.decode_stage_b(self.decode_stage_a(latents_nchw))

    def decode_stage_a(self, latents_nchw):
        """post_quant_conv, conv_in and the mid block (the global attention)
        at latent resolution: (B,4,h,w) -> (B,C_top,h,w), channels_last."""
        return self.decoder.stage_a(self.post_quant_conv(
            self._entry(latents_nchw)))

    def decode_stage_b(self, hidden_nchw):
        """The upsampling stack, whose receptive field is finite:
        (B,C_top,h,w) -> (B,3,8h,8w)."""
        return self.decoder.stage_b(self._entry(hidden_nchw)).contiguous()

    def forward(self, images_nchw, noise):
        return self.decode(self.encode_sample(images_nchw, noise))
