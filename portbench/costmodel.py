"""The benchmark's frozen cost model: FLOPs of a UNet forward and of a VAE
decode, the UNet's attention calls, and the H100's published peaks.

The counts are a frozen copy of the program's ``utils/flops.py`` (matrix work
only: convolutions, dense layers and the two attention products, at 2 FLOPs
a multiply-add), walked over a diffusers config dict, so that no change of
the program moves the yardstick that its speed is measured against.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple

# NVIDIA's data sheet, H100 SXM, dense, at the full 700 W
BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12
# the program's attention kernel takes non-causal calls of >= 256 queries;
# smaller ones (SD 2.x's 8 x 8 mid block) run as plain library ops
FLASH_MIN_SEQ = 256


def _lists(cfg: dict):
    bo = list(cfg["block_out_channels"])
    n = len(bo)
    depth = cfg.get("transformer_layers_per_block", 1)
    depth = [depth] * n if isinstance(depth, int) else list(depth)
    heads = cfg["attention_head_dim"]
    heads = [heads] * n if isinstance(heads, int) else list(heads)
    attn = [t.startswith("CrossAttn") for t in cfg["down_block_types"]]
    return bo, n, depth, heads, attn


class AttnCall(NamedTuple):
    """One attention call of one batch row: queries, keys, channels
    (heads x head dim), heads, and how many such calls a forward makes."""

    sq: int
    sk: int
    channels: int
    heads: int
    count: int


def _walk(cfg: dict, h: int, w: int, ctx_len: int = 77):
    """(flops per row, attention calls per row) of one UNet forward at a
    latent of h x w, as ``utils/flops.py`` walks it."""
    bo, n, depth, heads, attn = _lists(cfg)
    temb = 4 * bo[0]
    ctx_dim = cfg["cross_attention_dim"]
    flops = 0
    calls: List[AttnCall] = []

    def conv(hh, ww, cin, cout, k=3):
        nonlocal flops
        flops += 2 * hh * ww * cin * cout * k * k

    def dense(tokens, din, dout):
        nonlocal flops
        flops += 2 * tokens * din * dout

    def resnet(hh, ww, cin, cout):
        conv(hh, ww, cin, cout)
        conv(hh, ww, cout, cout)
        dense(1, temb, cout)
        if cin != cout:
            conv(hh, ww, cin, cout, 1)

    def transformer(hh, ww, c, d, nheads):
        nonlocal flops
        s = hh * ww
        dense(s, c, c)
        dense(s, c, c)
        for _ in range(d):
            for _ in range(4):
                dense(s, c, c)
            flops += 4 * s * s * c
            dense(s, c, c)
            dense(s, c, c)
            dense(ctx_len, ctx_dim, c)
            dense(ctx_len, ctx_dim, c)
            flops += 4 * s * ctx_len * c
            dense(s, c, 8 * c)
            dense(s, 4 * c, c)
        calls.append(AttnCall(s, s, c, nheads, d))
        calls.append(AttnCall(s, ctx_len, c, nheads, d))

    conv(h, w, cfg["in_channels"], bo[0])
    dense(1, bo[0], temb)
    dense(1, temb, temb)
    if cfg.get("addition_embed_type") == "text_time":
        dense(1, cfg["projection_class_embeddings_input_dim"], temb)
        dense(1, temb, temb)
    skips = [(bo[0], h, w)]
    cin = bo[0]
    for i in range(n):
        for _ in range(cfg["layers_per_block"]):
            resnet(h, w, cin, bo[i])
            if attn[i]:
                transformer(h, w, bo[i], depth[i], heads[i])
            cin = bo[i]
            skips.append((cin, h, w))
        if i < n - 1:
            h, w = h // 2, w // 2
            conv(h, w, bo[i], bo[i])
            skips.append((bo[i], h, w))
    resnet(h, w, bo[-1], bo[-1])
    transformer(h, w, bo[-1], depth[-1], heads[-1])
    resnet(h, w, bo[-1], bo[-1])
    for i in reversed(range(n)):
        for _ in range(cfg["layers_per_block"] + 1):
            sc, h, w = skips.pop()
            resnet(h, w, cin + sc, bo[i])
            if attn[i]:
                transformer(h, w, bo[i], depth[i], heads[i])
            cin = bo[i]
        if i > 0:
            h, w = h * 2, w * 2
            conv(h, w, bo[i], bo[i])
    conv(h, w, bo[0], cfg["out_channels"])
    return flops, calls


def unet_forward_flops(cfg: dict, h: int, w: int) -> int:
    """Matrix FLOPs of one UNet forward of one batch row at a latent of h x w."""
    return _walk(cfg, h, w)[0]


def unet_attention_calls(cfg: dict, h: int, w: int) -> List[AttnCall]:
    """The attention calls of one UNet forward row that the program's
    attention kernel takes (>= FLASH_MIN_SEQ queries)."""
    return [c for c in _walk(cfg, h, w)[1] if c.sq >= FLASH_MIN_SEQ]


def attention_bound_seconds(calls: List[AttnCall], bytes_per_el: int = 2) -> float:
    """Least time of the calls on one H100: for each, the larger of its
    operations (QK^T and PV, 4 Sq Sk C) over the bf16 peak and its bytes
    (Q, K, V read once, O written once) over HBM's rate."""
    total = 0.0
    for c in calls:
        ops = 4 * c.sq * c.sk * c.channels
        nbytes = bytes_per_el * c.channels * (2 * c.sq + 2 * c.sk)
        total += c.count * max(ops / BF16_FLOPS, nbytes / HBM_BYTES_PER_S)
    return total


def vae_decoder_flops(cfg: dict, lat_h: int, lat_w: int) -> int:
    """Matrix FLOPs of one VAE decode of a latent of lat_h x lat_w."""
    bo = list(reversed(cfg["block_out_channels"]))
    lat = cfg["latent_channels"]
    h, w = lat_h, lat_w
    f = 2 * h * w * lat * lat                       # post_quant_conv
    f += 2 * h * w * lat * bo[0] * 9                # conv_in

    def resnet(hh, ww, cin, cout):
        out = 2 * hh * ww * (cin * cout + cout * cout) * 9
        return out + (2 * hh * ww * cin * cout if cin != cout else 0)
    f += resnet(h, w, bo[0], bo[0])
    s = h * w
    f += 4 * 2 * s * bo[0] * bo[0] + 4 * s * s * bo[0]  # mid attention
    f += resnet(h, w, bo[0], bo[0])
    cin = bo[0]
    for i, ch in enumerate(bo):
        for _ in range(cfg["layers_per_block"] + 1):
            f += resnet(h, w, cin, ch)
            cin = ch
        if i < len(bo) - 1:
            h, w = h * 2, w * 2
            f += 2 * h * w * ch * ch * 9
    f += 2 * h * w * bo[-1] * cfg.get("out_channels", 3) * 9
    return f


def image_costs(cfg: dict, traffic: dict, steps: int, views: int) -> Dict[str, float]:
    """Per image of a cell: UNet rows run, model FLOPs (UNet rows at the
    native latent plus one VAE decode; text encoders and background encodes
    left out) and the attention bound seconds."""
    rs = int(traffic["resampling_steps"])
    repaint = bool(traffic.get("repaint_sampling", True)) and rs > 0
    rows = steps * (2 * (rs + 1) + views) + ((steps - 1) * (2 + views) if repaint else 0)
    s = cfg["unet"]["sample_size"]
    vsf = 2 ** (len(cfg["vae"]["block_out_channels"]) - 1)
    lat_h, lat_w = traffic["height"] // vsf, traffic["width"] // vsf
    return {
        "unet_rows": rows,
        "flops": rows * unet_forward_flops(cfg["unet"], s, s)
        + vae_decoder_flops(cfg["vae"], lat_h, lat_w),
        "attn_bound_s": rows * attention_bound_seconds(
            unet_attention_calls(cfg["unet"], s, s)),
    }
