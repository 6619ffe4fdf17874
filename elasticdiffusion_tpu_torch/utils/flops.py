"""Analytic cost model (FLOPs and HBM bytes) of the UNet, ControlNet and VAE
decoder forwards, and their roofline.

Counterpart of ``elasticdiffusion_tpu/utils/flops.py``, walking the same
structure (stem, down blocks, mid, up blocks with skip concats, out head)
over the port's configs, with the same counts: FLOPs count the matrix work
only (convolutions, dense layers, attention dots) at 2 FLOPs a
multiply-add; bytes count the weights once and the activations of
convolutions and dense layers once, so they are a floor. The defaults of
``roofline_seconds`` are H100 SXM peaks. Nothing on the pipeline's path
calls this module; a benchmark reads it.
"""

from __future__ import annotations

import math

from ..configs import UNetConfig

# NVIDIA's data sheet peaks of one H100 SXM (dense, at the full 700 W power
# limit): datasheet figures, not measurements. chip_smoke.py's bounds use
# them too.
H100_BF16_TFLOPS = 989.0
H100_FP32_TFLOPS = 67.0
H100_HBM_GBPS = 3350.0


class _Cost:
    """Accumulates (flops, param_bytes, act_bytes) over walked ops.

    bytes_per_el: 2 for the bf16 path (default), 4 for fp32 paths
    (force_upcast VAE decode)."""

    def __init__(self, bytes_per_el: int = 2):
        self.bytes_per_el = bytes_per_el
        self.flops = 0
        self.attn_dot_flops = 0  # the QK^T and PV dots
        self.param_bytes = 0
        self.act_bytes = 0

    def conv(self, h, w, cin, cout, k=3):
        self.flops += 2 * h * w * cin * cout * k * k
        self.param_bytes += (cin * cout * k * k + cout) * self.bytes_per_el
        self.act_bytes += (h * w * cin + h * w * cout) * self.bytes_per_el

    def dense(self, tokens, din, dout, bias=True):
        self.flops += 2 * tokens * din * dout
        self.param_bytes += (din * dout
                             + (dout if bias else 0)) * self.bytes_per_el
        self.act_bytes += (tokens * din + tokens * dout) * self.bytes_per_el

    def attn_dots(self, s_q, s_k, c):
        # QK^T + PV at 2 FLOPs/MAC each; flash attention keeps the (s_q,s_k)
        # logits on chip, so no HBM bytes for them
        self.flops += 2 * 2 * s_q * s_k * c
        self.attn_dot_flops += 2 * 2 * s_q * s_k * c

    def resnet(self, h, w, cin, cout, temb_dim):
        self.conv(h, w, cin, cout)
        self.conv(h, w, cout, cout)
        if temb_dim:  # time_emb_proj (per batch row); VAE resnets have none
            self.dense(1, temb_dim, cout)
        if cin != cout:
            self.conv(h, w, cin, cout, k=1)  # conv_shortcut

    def transformer(self, h, w, c, depth, ctx_len, ctx_dim):
        s = h * w
        self.dense(s, c, c)  # proj_in (linear == 1x1 conv cost)
        self.dense(s, c, c)  # proj_out
        for _ in range(depth):
            for _qkv in range(3):  # self-attention to_q/k/v (no bias)
                self.dense(s, c, c, bias=False)
            self.dense(s, c, c)  # to_out
            self.attn_dots(s, s, c)
            # cross-attention: to_q (no bias) / to_out on x, to_k/v on context
            self.dense(s, c, c, bias=False)
            self.dense(s, c, c)
            self.dense(ctx_len, ctx_dim, c, bias=False)
            self.dense(ctx_len, ctx_dim, c, bias=False)
            self.attn_dots(s, ctx_len, c)
            # GEGLU feed-forward: c -> 2*4c, then 4c -> c
            self.dense(s, c, 8 * c)
            self.dense(s, 4 * c, c)

    def snapshot(self):
        return {"flops": self.flops, "attn_dot_flops": self.attn_dot_flops,
                "param_bytes": self.param_bytes,
                "act_bytes": self.act_bytes}


def unet_stage_costs(cfg: UNetConfig, height: int, width: int,
                     ctx_len: int = 77) -> dict:
    """Per-stage {flops, attn_dot_flops, param_bytes, act_bytes} of ONE UNet
    forward at latent (height, width); flops/act_bytes are per batch row.
    Stages: 'stem', 'down_i', 'mid', 'up_i', 'out'."""
    bo = cfg.block_out_channels
    n = len(bo)
    temb = bo[0] * 4
    h, w = height, width
    out = {}

    c = _Cost()
    c.conv(h, w, cfg.in_channels, bo[0])  # stem conv_in
    # time embedding MLP (+ SDXL add_embedding)
    c.dense(1, bo[0], temb)
    c.dense(1, temb, temb)
    if cfg.addition_embed_type == "text_time":
        c.dense(1, cfg.projection_class_embeddings_input_dim, temb)
        c.dense(1, temb, temb)
    out["stem"] = c.snapshot()

    # down path; record skip channels for the up path
    skips = [(bo[0], h, w)]
    cin = bo[0]
    for i in range(n):
        c = _Cost()
        for _ in range(cfg.layers_per_block):
            c.resnet(h, w, cin, bo[i], temb)
            if cfg.down_block_has_attn[i]:
                c.transformer(h, w, bo[i],
                              cfg.transformer_layers_per_block[i],
                              ctx_len, cfg.cross_attention_dim)
            cin = bo[i]
            skips.append((cin, h, w))
        if i < n - 1:
            h, w = h // 2, w // 2
            c.conv(h, w, bo[i], bo[i])  # stride-2 downsampler
            skips.append((bo[i], h, w))
        out[f"down_{i}"] = c.snapshot()

    c = _Cost()
    c.resnet(h, w, bo[-1], bo[-1], temb)
    c.transformer(h, w, bo[-1], cfg.transformer_layers_per_block[-1],
                  ctx_len, cfg.cross_attention_dim)
    c.resnet(h, w, bo[-1], bo[-1], temb)
    out["mid"] = c.snapshot()

    # up path (skip concats widen resnet input channels)
    cin = bo[-1]
    for i in reversed(range(n)):
        c = _Cost()
        for _ in range(cfg.layers_per_block + 1):
            skip_ch, h, w = skips.pop()
            c.resnet(h, w, cin + skip_ch, bo[i], temb)
            if cfg.down_block_has_attn[i]:
                c.transformer(h, w, bo[i],
                              cfg.transformer_layers_per_block[i],
                              ctx_len, cfg.cross_attention_dim)
            cin = bo[i]
        if i > 0:
            h, w = h * 2, w * 2
            c.conv(h, w, bo[i], bo[i])  # upsampler conv (post-nearest-2x)
        out[f"up_{i}"] = c.snapshot()

    c = _Cost()
    c.conv(h, w, bo[0], cfg.out_channels)
    out["out"] = c.snapshot()
    return out


def unet_stage_flops(cfg: UNetConfig, height: int, width: int,
                     ctx_len: int = 77) -> dict:
    """Per-stage matmul/conv FLOPs (see unet_stage_costs)."""
    return {k: v["flops"]
            for k, v in unet_stage_costs(cfg, height, width, ctx_len).items()}


def unet_forward_flops(cfg: UNetConfig, height: int, width: int,
                       ctx_len: int = 77) -> int:
    """Total matmul/conv FLOPs of ONE UNet forward, per batch row."""
    return sum(unet_stage_flops(cfg, height, width, ctx_len).values())


def controlnet_costs(cn_cfg, height: int, width: int,
                     ctx_len: int = 77) -> dict:
    """{flops, attn_dot_flops, param_bytes, act_bytes} of ONE ControlNet
    forward at latent (height, width), per batch row (models/controlnet.py):
    conditioning embedding (strided conv pyramid over the pixel-resolution
    condition), the UNet's down+mid twin, and the per-residual zero convs.
    A conditioned step adds it to every UNet call."""
    cfg = cn_cfg.unet
    bo = cfg.block_out_channels
    n = len(bo)
    temb = bo[0] * 4
    h, w = height, width
    c = _Cost()

    # conditioning embedding: pixel res -> latent res via stride-2 convs
    k = int(math.log2(cn_cfg.cond_downsample_factor))
    ch = cn_cfg.conditioning_embedding_out_channels[-(k + 1):]
    ph, pw = h * cn_cfg.cond_downsample_factor, w * cn_cfg.cond_downsample_factor
    c.conv(ph, pw, cn_cfg.conditioning_channels, ch[0])
    for i in range(len(ch) - 1):
        c.conv(ph, pw, ch[i], ch[i])
        ph, pw = ph // 2, pw // 2
        c.conv(ph, pw, ch[i], ch[i + 1])
    c.conv(h, w, ch[-1], bo[0])  # cond conv_out (zero-init, still computed)

    c.conv(h, w, cfg.in_channels, bo[0])  # conv_in
    c.dense(1, bo[0], temb)
    c.dense(1, temb, temb)
    if cfg.addition_embed_type == "text_time":
        c.dense(1, cfg.projection_class_embeddings_input_dim, temb)
        c.dense(1, temb, temb)

    c.conv(h, w, bo[0], bo[0], k=1)  # zero conv on the conv_in residual
    cin = bo[0]
    for i in range(n):
        for _ in range(cfg.layers_per_block):
            c.resnet(h, w, cin, bo[i], temb)
            if cfg.down_block_has_attn[i]:
                c.transformer(h, w, bo[i],
                              cfg.transformer_layers_per_block[i],
                              ctx_len, cfg.cross_attention_dim)
            cin = bo[i]
            c.conv(h, w, cin, cin, k=1)  # zero conv
        if i < n - 1:
            h, w = h // 2, w // 2
            c.conv(h, w, bo[i], bo[i])  # downsampler
            c.conv(h, w, bo[i], bo[i], k=1)  # zero conv
    c.resnet(h, w, bo[-1], bo[-1], temb)
    c.transformer(h, w, bo[-1], cfg.transformer_layers_per_block[-1],
                  ctx_len, cfg.cross_attention_dim)
    c.resnet(h, w, bo[-1], bo[-1], temb)
    c.conv(h, w, bo[-1], bo[-1], k=1)  # mid zero conv
    return c.snapshot()


def vae_decoder_costs(cfg, lat_h: int, lat_w: int,
                      bytes_per_el: int = 4) -> dict:
    """{flops, attn_dot_flops, param_bytes, act_bytes} of ONE VAE decode at
    latent (lat_h, lat_w) — models/vae.py Decoder: post_quant conv, conv_in,
    mid (resnet/attn/resnet), reversed-channel up stack with nearest-2x
    upsamplers, out head. bytes_per_el defaults to 4: SDXL decodes in fp32
    (force_upcast); its FLOPs then run at the fp32 rate
    (``H100_FP32_TFLOPS``), not the bf16 one."""
    bo = list(reversed(cfg.block_out_channels))
    h, w = lat_h, lat_w
    c = _Cost(bytes_per_el)
    c.conv(h, w, cfg.latent_channels, cfg.latent_channels, k=1)  # post_quant
    c.conv(h, w, cfg.latent_channels, bo[0])  # conv_in
    c.resnet(h, w, bo[0], bo[0], 0)
    # single-head mid attention at latent resolution
    s = h * w
    for _ in range(4):  # qkv + out projections
        c.dense(s, bo[0], bo[0])
    c.attn_dots(s, s, bo[0])
    c.resnet(h, w, bo[0], bo[0], 0)
    cin = bo[0]
    for i, ch in enumerate(bo):
        for _ in range(cfg.layers_per_block + 1):
            c.resnet(h, w, cin, ch, 0)
            cin = ch
        if i < len(bo) - 1:
            h, w = h * 2, w * 2
            c.conv(h, w, ch, ch)  # upsampler conv (post-nearest-2x)
    c.conv(h, w, bo[-1], cfg.out_channels)  # out head
    return c.snapshot()


def roofline_seconds(cost: dict, batch: int,
                     tflops_peak: float = H100_BF16_TFLOPS,
                     hbm_gbps: float = H100_HBM_GBPS) -> dict:
    """Lower-bound stage seconds from one {flops, param_bytes, act_bytes}
    entry at the given batch: max(compute bound, HBM bound). Weights are
    read once per program regardless of batch; flops/activations scale."""
    t_compute = batch * cost["flops"] / (tflops_peak * 1e12)
    t_hbm = (cost["param_bytes"] + batch * cost["act_bytes"]) / (hbm_gbps * 1e9)
    return {"compute_s": t_compute, "hbm_s": t_hbm,
            "bound": "compute" if t_compute >= t_hbm else "hbm",
            "floor_s": max(t_compute, t_hbm)}
