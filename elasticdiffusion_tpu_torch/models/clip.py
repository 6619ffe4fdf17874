"""CLIP text encoders (ViT-L/14, ViT-H/14, ViT-bigG/14 with projection).

Counterpart of ``elasticdiffusion_tpu/models/clip.py``:
  - non-XL: the final hidden state after the last LayerNorm
  - XL: hidden_states[-2] of both encoders (the input of the last layer),
    and the pooled output = text projection of the EOS-position feature
  - causal attention mask; 77-token padded inputs

The encoder returns (last_hidden_state, penultimate_hidden_state, pooled) in
one pass. The attention is causal and never takes the kernel (the gate in
``kernels/attention.py`` is non-causal); the LayerNorms are the same row
LayerNorm as the UNet's and share its kernel.

Module names follow the transformers checkpoint (``text_model.encoder.
layers.{i}.self_attn.q_proj`` ...).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..configs import CLIPTextConfig
from ..kernels.attention import dot_product_attention
from .layers import LayerNorm32


def _act(name: str):
    if name == "quick_gelu":
        return lambda x: x * torch.sigmoid(1.702 * x)
    if name == "gelu":
        return F.gelu  # exact (erf)
    raise ValueError(name)


class _SelfAttention(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        C = cfg.hidden_size
        self.num_heads = cfg.num_heads
        self.q_proj = nn.Linear(C, C)
        self.k_proj = nn.Linear(C, C)
        self.v_proj = nn.Linear(C, C)
        self.out_proj = nn.Linear(C, C)

    def forward(self, h):
        B, S, C = h.shape
        shape = (B, S, self.num_heads, C // self.num_heads)
        q = self.q_proj(h).view(shape)
        k = self.k_proj(h).view(shape)
        v = self.v_proj(h).view(shape)
        attn = dot_product_attention(q, k, v, causal=True, use_kernels="off")
        return self.out_proj(attn.reshape(B, S, C))


class _MLP(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.fc1 = nn.Linear(cfg.hidden_size, cfg.intermediate_size)
        self.fc2 = nn.Linear(cfg.intermediate_size, cfg.hidden_size)
        self.act = _act(cfg.hidden_act)

    def forward(self, h):
        return self.fc2(self.act(self.fc1(h)))


class CLIPEncoderLayer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig, use_kernels: str = "auto"):
        super().__init__()
        self.layer_norm1 = LayerNorm32(cfg.hidden_size, cfg.layer_norm_eps,
                                       use_kernels)
        self.self_attn = _SelfAttention(cfg)
        self.layer_norm2 = LayerNorm32(cfg.hidden_size, cfg.layer_norm_eps,
                                       use_kernels)
        self.mlp = _MLP(cfg)

    def forward(self, x):
        x = x + self.self_attn(self.layer_norm1(x))
        return x + self.mlp(self.layer_norm2(x))


class _Embeddings(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embedding = nn.Embedding(cfg.max_position_embeddings,
                                               cfg.hidden_size)


class _Encoder(nn.Module):
    def __init__(self, cfg: CLIPTextConfig, use_kernels: str):
        super().__init__()
        self.layers = nn.ModuleList([CLIPEncoderLayer(cfg, use_kernels)
                                     for _ in range(cfg.num_layers)])


class _TextTransformer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig, use_kernels: str):
        super().__init__()
        self.embeddings = _Embeddings(cfg)
        self.encoder = _Encoder(cfg, use_kernels)
        self.final_layer_norm = LayerNorm32(cfg.hidden_size,
                                            cfg.layer_norm_eps, use_kernels)


class CLIPTextModel(nn.Module):
    def __init__(self, config: CLIPTextConfig, use_kernels: str = "auto"):
        super().__init__()
        self.config = config
        self.text_model = _TextTransformer(config, use_kernels)
        if config.projection_dim is not None:
            self.text_projection = nn.Linear(config.hidden_size,
                                             config.projection_dim, bias=False)

    def forward(self, input_ids: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """input_ids: (B, 77) integer tensor.

        Returns (last_hidden_state, penultimate_hidden_state, pooled):
          last_hidden_state  (B, 77, C): after the final LayerNorm
          penultimate        (B, 77, C): HF hidden_states[-2]
          pooled             (B, C or projection_dim): the EOS feature,
                             projected when the config has a projection head
        """
        tm = self.text_model
        B, S = input_ids.shape
        ids = input_ids.long()
        x = tm.embeddings.token_embedding(ids) \
            + tm.embeddings.position_embedding.weight[None, :S]
        penultimate = None
        n = len(tm.encoder.layers)
        for i, layer in enumerate(tm.encoder.layers):
            if i == n - 1:
                penultimate = x
            x = layer(x)
        last = tm.final_layer_norm(x)
        # pooled = feature at the EOS position: argmax(input_ids) is the first
        # occurrence of the highest token id, the first EOS for CLIP vocabs
        eos_idx = ids.argmax(dim=-1)
        pooled = last[torch.arange(B, device=last.device), eos_idx]
        if self.config.projection_dim is not None:
            pooled = self.text_projection(pooled)
        return last, penultimate, pooled
