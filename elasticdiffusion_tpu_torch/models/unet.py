"""UNet2DCondition covering SD 1.x / SD 2.x / SDXL from one config.

Counterpart of ``elasticdiffusion_tpu/models/unet.py`` (its full forward):
an epsilon-prediction UNet with cross-attention on the text embedding and,
for SDXL, 'text_time' added conditioning. The TPU-runtime parts of the JAX
module (segmented stages, scan restacking, remat) have no counterpart here.
``UNetTrunk`` is the stem, embedding, down and mid path that the UNet shares
with the ControlNet (``models/controlnet.py``); the UNet takes the
ControlNet's residuals as ``down_block_residuals`` / ``mid_block_residual``.

Public call takes and returns NCHW. Inside, tensors are NCHW in the
``channels_last`` memory format (see ``models/layers.py``). Module names
follow the diffusers checkpoint (``down_blocks.{i}.resnets.{j}`` ...).
"""

from __future__ import annotations

import numbers
from typing import Optional, Sequence

import torch
import torch.nn as nn

from ..configs import UNetConfig
from .layers import (Conv3x3, Downsample2D, GroupNorm32, ResnetBlock2D,
                     TimestepEmbedding, Transformer2D, Upsample2D,
                     timestep_embedding)


class _Block(nn.Module):
    """resnets (+ attentions) (+ one down/upsampler), diffusers naming."""

    def __init__(self):
        super().__init__()
        self.resnets = nn.ModuleList()
        self.attentions = nn.ModuleList()


class UNetTrunk(nn.Module):
    """conv_in, the time (and SDXL add) embedding, the down blocks and the
    mid block: the part of the UNet that the ControlNet copies. Modules are
    registered in the UNet's order, so a seeded init gives the UNet the same
    weights as before the split."""

    def __init__(self, config: UNetConfig, use_kernels: str = "auto"):
        super().__init__()
        self.config = cfg = config
        bo = cfg.block_out_channels
        n = len(bo)
        temb_dim = bo[0] * 4
        uk = use_kernels

        self.conv_in = Conv3x3(cfg.in_channels, bo[0])
        self.time_embedding = TimestepEmbedding(bo[0], temb_dim)
        if cfg.addition_embed_type == "text_time":
            self.add_embedding = TimestepEmbedding(
                cfg.projection_class_embeddings_input_dim, temb_dim)

        self.down_blocks = nn.ModuleList()
        ch = bo[0]
        for i in range(n):
            blk = _Block()
            for _ in range(cfg.layers_per_block):
                blk.resnets.append(ResnetBlock2D(ch, bo[i], temb_dim,
                                                 use_kernels=uk))
                ch = bo[i]
                if cfg.down_block_has_attn[i]:
                    blk.attentions.append(self._transformer(i, uk))
            if i < n - 1:
                blk.downsamplers = nn.ModuleList([Downsample2D(ch)])
            self.down_blocks.append(blk)

        self.mid_block = _Block()
        self.mid_block.resnets.append(ResnetBlock2D(ch, ch, temb_dim,
                                                    use_kernels=uk))
        self.mid_block.attentions.append(self._transformer(n - 1, uk))
        self.mid_block.resnets.append(ResnetBlock2D(ch, ch, temb_dim,
                                                    use_kernels=uk))

    def _transformer(self, i: int, use_kernels: str) -> Transformer2D:
        cfg = self.config
        bo = cfg.block_out_channels
        heads = cfg.heads_for_block(i)
        return Transformer2D(bo[i], heads, bo[i] // heads,
                             cfg.cross_attention_dim,
                             depth=cfg.transformer_layers_per_block[i],
                             use_linear_projection=cfg.use_linear_projection,
                             use_kernels=use_kernels)

    @property
    def dtype(self) -> torch.dtype:
        return self.conv_in.weight.dtype

    def _embedding(self, timesteps, B, added_text_embeds, added_time_ids):
        cfg = self.config
        dev = self.conv_in.weight.device
        if isinstance(timesteps, numbers.Number):
            # a fill, where as_tensor would copy from the host and wait
            t = torch.full((), timesteps, dtype=torch.float32, device=dev)
        else:
            t = torch.as_tensor(timesteps, dtype=torch.float32, device=dev)
        if t.dim() == 0:
            t = t.expand(B)
        t_emb = timestep_embedding(t, cfg.block_out_channels[0],
                                   cfg.flip_sin_to_cos, cfg.freq_shift)
        e = self.time_embedding(t_emb.to(self.dtype))
        if cfg.addition_embed_type == "text_time":
            if added_text_embeds is None or added_time_ids is None:
                raise ValueError("SDXL requires added_text_embeds and "
                                 "added_time_ids")
            tid_emb = timestep_embedding(
                added_time_ids.reshape(-1), cfg.addition_time_embed_dim,
                cfg.flip_sin_to_cos, cfg.freq_shift).reshape(B, -1)
            add_in = torch.cat([added_text_embeds.float(), tid_emb], dim=-1)
            if add_in.shape[-1] != cfg.projection_class_embeddings_input_dim:
                raise ValueError(
                    f"add-embed dim {add_in.shape[-1]} != "
                    f"{cfg.projection_class_embeddings_input_dim}")
            e = e + self.add_embedding(add_in.to(self.dtype))
        return e

    def _down(self, x, e, context):
        """The down path: (x, its skips), the input first, then the output of
        every resnet (+ attention) and downsampler."""
        residuals = [x]
        for blk in self.down_blocks:
            for j, resnet in enumerate(blk.resnets):
                x = resnet(x, e)
                if len(blk.attentions):
                    x = blk.attentions[j](x, context)
                residuals.append(x)
            if hasattr(blk, "downsamplers"):
                x = blk.downsamplers[0](x)
                residuals.append(x)
        return x, residuals

    def _mid(self, x, e, context):
        x = self.mid_block.resnets[0](x, e)
        x = self.mid_block.attentions[0](x, context)
        return self.mid_block.resnets[1](x, e)


class UNet2DCondition(UNetTrunk):
    def __init__(self, config: UNetConfig, use_kernels: str = "auto"):
        super().__init__(config, use_kernels)
        cfg = config
        bo = cfg.block_out_channels
        n = len(bo)
        temb_dim = bo[0] * 4
        uk = use_kernels
        ch = bo[-1]

        # diffusers up block k works at the channel index i = n - 1 - k
        self.up_blocks = nn.ModuleList()
        for k in range(n):
            i = n - 1 - k
            blk = _Block()
            for j in range(cfg.layers_per_block + 1):
                skip = bo[i] if j < cfg.layers_per_block else bo[max(i - 1, 0)]
                blk.resnets.append(ResnetBlock2D(ch + skip, bo[i], temb_dim,
                                                 use_kernels=uk))
                ch = bo[i]
                if cfg.down_block_has_attn[i]:
                    blk.attentions.append(self._transformer(i, uk))
            if i > 0:
                blk.upsamplers = nn.ModuleList([Upsample2D(ch)])
            self.up_blocks.append(blk)

        self.conv_norm_out = GroupNorm32(bo[0], silu=True, use_kernels=uk)
        self.conv_out = Conv3x3(bo[0], cfg.out_channels)

    def forward(self, sample_nchw: torch.Tensor, timesteps,
                encoder_hidden_states: torch.Tensor,
                added_text_embeds: Optional[torch.Tensor] = None,
                added_time_ids: Optional[torch.Tensor] = None,
                down_block_residuals: Optional[Sequence[torch.Tensor]] = None,
                mid_block_residual: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        """sample (B, C, H, W) + timesteps (scalar or (B,)) + context
        (B, 77, D) -> eps (B, C, H, W) in the compute dtype.

        The ControlNet's residuals (NCHW, one per skip of the down path and
        one for the mid block) are added in the compute dtype to the skips
        after the whole down path and to the mid block's output."""
        dt = self.dtype
        context = encoder_hidden_states.to(dt)
        x = sample_nchw.to(dt).contiguous(memory_format=torch.channels_last)
        x = self.conv_in(x)
        e = self._embedding(timesteps, x.shape[0], added_text_embeds,
                            added_time_ids)

        x, residuals = self._down(x, e, context)
        if down_block_residuals is not None:
            if len(down_block_residuals) != len(residuals):
                raise ValueError(f"expected {len(residuals)} down residuals, "
                                 f"got {len(down_block_residuals)}")
            residuals = [r + a.to(r.dtype)
                         for r, a in zip(residuals, down_block_residuals)]

        x = self._mid(x, e, context)
        if mid_block_residual is not None:
            x = x + mid_block_residual.to(x.dtype)

        for blk in self.up_blocks:
            for j, resnet in enumerate(blk.resnets):
                x = resnet(torch.cat([x, residuals.pop()], dim=1), e)
                if len(blk.attentions):
                    x = blk.attentions[j](x, context)
            if hasattr(blk, "upsamplers"):
                x = blk.upsamplers[0](x)

        x = self.conv_out(self.conv_norm_out(x))
        return x.contiguous()
