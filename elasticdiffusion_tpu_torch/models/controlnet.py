"""ControlNet for SD 1.x / 2.x and SDXL, as an nn.Module.

Counterpart of ``elasticdiffusion_tpu/models/controlnet.py``: a copy of the
UNet's stem, embedding, down and mid path (``UNetTrunk``) with (a) a
conditioning embedding that takes the RGB condition in [0, 1] at pixel
resolution down by the VAE's scale factor and adds it to ``conv_in``'s
output, and (b) a 1x1 "zero" convolution on every residual. It returns one
residual per skip of the down path plus the mid residual, each times
``conditioning_scale``; ``UNet2DCondition.forward`` takes them as
``down_block_residuals`` / ``mid_block_residual``.

Its ResNet blocks, transformers and in-gate 3x3 convolutions are the UNet's
own modules, so they take the GroupNorm, LayerNorm, attention and conv3x3
kernels under the same ``use_kernels`` / ``conv_impl`` rules. The
convolutions that the JAX package leaves to XLA stay library convolutions
(``layers.Conv2d``, cuDNN on the card): the conditioning embedding at pixel
resolution and the 1x1 zero convolutions.

Module names follow the diffusers ``ControlNetModel`` checkpoint
(``controlnet_cond_embedding.blocks.{i}``, ``controlnet_down_blocks.{k}``,
``controlnet_mid_block``).
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..configs import ControlNetConfig
from .layers import Conv2d
from .unet import UNetTrunk


class ConditioningEmbedding(nn.Module):
    """RGB condition -> latent-resolution feature: log2(factor) stride-2
    3x3 convs (3 for the real 8x VAEs), each after a stride-1 one, SiLU
    between all of them."""

    def __init__(self, in_channels: int, out_channels: int,
                 block_channels: Tuple[int, ...] = (16, 32, 96, 256),
                 downsample_factor: int = 8):
        super().__init__()
        k = int(math.log2(downsample_factor))
        ch = block_channels[-(k + 1):]
        self.conv_in = Conv2d(in_channels, ch[0], 3, padding=1)
        self.blocks = nn.ModuleList()
        for i in range(len(ch) - 1):
            self.blocks.append(Conv2d(ch[i], ch[i], 3, padding=1))
            self.blocks.append(Conv2d(ch[i], ch[i + 1], 3, stride=2,
                                      padding=1))
        self.conv_out = Conv2d(ch[-1], out_channels, 3, padding=1)

    def forward(self, cond: torch.Tensor) -> torch.Tensor:
        x = F.silu(self.conv_in(cond))
        for block in self.blocks:
            x = F.silu(block(x))
        return self.conv_out(x)


class ControlNet(UNetTrunk):
    def __init__(self, config: ControlNetConfig, use_kernels: str = "auto"):
        super().__init__(config.unet, use_kernels)
        bo = config.unet.block_out_channels
        self.controlnet_cond_embedding = ConditioningEmbedding(
            config.conditioning_channels, bo[0],
            config.conditioning_embedding_out_channels,
            config.cond_downsample_factor)
        skips = [bo[0]]
        for i, c in enumerate(bo):
            skips += [c] * config.unet.layers_per_block
            if i < len(bo) - 1:
                skips.append(c)
        self.controlnet_down_blocks = nn.ModuleList(
            Conv2d(c, c, 1) for c in skips)
        self.controlnet_mid_block = Conv2d(bo[-1], bo[-1], 1)

    def forward(self, sample_nchw: torch.Tensor, timesteps,
                encoder_hidden_states: torch.Tensor,
                condition_nchw: torch.Tensor, conditioning_scale: float = 1.0,
                added_text_embeds: Optional[torch.Tensor] = None,
                added_time_ids: Optional[torch.Tensor] = None
                ) -> Tuple[List[torch.Tensor], torch.Tensor]:
        """sample (B, C, h, w), condition (B, 3, h * f, w * f) in [0, 1]
        -> (down residuals, mid residual), NCHW in the compute dtype."""
        dt = self.dtype
        cl = torch.channels_last
        context = encoder_hidden_states.to(dt)
        x = self.conv_in(sample_nchw.to(dt).contiguous(memory_format=cl))
        e = self._embedding(timesteps, x.shape[0], added_text_embeds,
                            added_time_ids)
        x = x + self.controlnet_cond_embedding(
            condition_nchw.to(dt).contiguous(memory_format=cl))
        x, residuals = self._down(x, e, context)
        x = self._mid(x, e, context)
        down = [conditioning_scale * zero(r)
                for zero, r in zip(self.controlnet_down_blocks, residuals)]
        return down, conditioning_scale * self.controlnet_mid_block(x)
