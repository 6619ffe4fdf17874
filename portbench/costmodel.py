"""The benchmark's frozen cost model: FLOPs of a UNet forward, of a
ControlNet forward and of a VAE decode, their attention calls, and the
H100's published peaks.

The counts are a frozen copy of the program's ``utils/flops.py`` (matrix work
only: convolutions, dense layers and the two attention products, at 2 FLOPs
a multiply-add), walked over a diffusers config dict, so that no change of
the program moves the yardstick that its speed is measured against.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple

# NVIDIA's data sheet, H100 SXM, dense, at the full 700 W
BF16_FLOPS = 989e12
TF32_FLOPS = 494.7e12
HBM_BYTES_PER_S = 3.35e12
# the fastest float32-exact product known on the card: three TF32 passes
# (hi x hi, hi x lo, lo x hi), the program's fp32 attention body's method
FP32_3XTF32_FLOPS = TF32_FLOPS / 3
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


def _walk(cfg: dict, h: int, w: int, ctx_len: int = 77, trunk: bool = False):
    """(flops per row, attention calls per row) of one UNet forward at a
    latent of h x w, as ``utils/flops.py`` walks it. With `trunk`, of the
    part that a ControlNet copies (conv_in, embeddings, down path, mid
    block) and its 1x1 zero convolutions, one on each skip and one on the
    mid block's output."""
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
    if trunk:
        for sc, hh, ww in skips + [(bo[-1], h, w)]:
            conv(hh, ww, sc, sc, 1)
        return flops, calls
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


def controlnet_forward_flops(cfg: dict, h: int, w: int) -> int:
    """Matrix FLOPs of one ControlNet forward of one batch row at a latent
    of h x w: its UNet trunk and zero convolutions, and the condition's
    embedding at the pixels (a 3x3 conv, per width a 3x3 conv and a stride-2
    one, and a 3x3 conv to the UNet's first width)."""
    ch = list(cfg["conditioning_embedding_out_channels"])
    f = 2 ** (len(ch) - 1)
    hh, ww = h * f, w * f
    flops = 2 * hh * ww * cfg.get("conditioning_channels", 3) * ch[0] * 9
    for a, b in zip(ch, ch[1:]):
        flops += 2 * hh * ww * a * a * 9
        hh, ww = hh // 2, ww // 2
        flops += 2 * hh * ww * a * b * 9
    flops += 2 * hh * ww * ch[-1] * cfg["block_out_channels"][0] * 9
    return flops + _walk(cfg, h, w, trunk=True)[0]


def controlnet_attention_calls(cfg: dict, h: int, w: int) -> List[AttnCall]:
    """The attention calls of one ControlNet forward row that the program's
    attention kernel takes (>= FLASH_MIN_SEQ queries)."""
    return [c for c in _walk(cfg, h, w, trunk=True)[1] if c.sq >= FLASH_MIN_SEQ]


def attention_bound_seconds(calls: List[AttnCall], bytes_per_el: int = 2,
                            flops_per_s: float = BF16_FLOPS) -> float:
    """Least time of the calls on one H100: for each, the larger of its
    operations (QK^T and PV, 4 Sq Sk C) over `flops_per_s` (the bf16 peak;
    for float32, ``FP32_3XTF32_FLOPS``) and its bytes (Q, K, V read once, O
    written once, `bytes_per_el` each) over HBM's rate."""
    total = 0.0
    for c in calls:
        ops = 4 * c.sq * c.sk * c.channels
        nbytes = bytes_per_el * c.channels * (2 * c.sq + 2 * c.sk)
        total += c.count * max(ops / flops_per_s, nbytes / HBM_BYTES_PER_S)
    return total


# a served dtype -> (bytes an element, the attention's operation rate)
ATTENTION_RATES = {"bfloat16": (2, BF16_FLOPS), "float32": (4, FP32_3XTF32_FLOPS)}


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
    native latent, with a ControlNet a ControlNet row for each, plus one VAE
    decode; text encoders and background encodes left out) and the
    attention bound seconds, each model's calls at the rate of the dtype
    that the configuration serves it in."""
    rs = int(traffic["resampling_steps"])
    repaint = bool(traffic.get("repaint_sampling", True)) and rs > 0
    rows = steps * (2 * (rs + 1) + views) + ((steps - 1) * (2 + views) if repaint else 0)
    s = cfg["unet"]["sample_size"]
    vsf = 2 ** (len(cfg["vae"]["block_out_channels"]) - 1)
    lat_h, lat_w = traffic["height"] // vsf, traffic["width"] // vsf
    row_flops = unet_forward_flops(cfg["unet"], s, s)
    bound = attention_bound_seconds(unet_attention_calls(cfg["unet"], s, s),
                                    *ATTENTION_RATES[cfg["dtypes"]["unet"]])
    if "controlnet" in cfg:
        cn = cfg["controlnet"]
        row_flops += controlnet_forward_flops(cn, s, s)
        bound += attention_bound_seconds(controlnet_attention_calls(cn, s, s),
                                         *ATTENTION_RATES[cfg["dtypes"]["controlnet"]])
    return {
        "unet_rows": rows,
        "flops": rows * row_flops + vae_decoder_flops(cfg["vae"], lat_h, lat_w),
        "attn_bound_s": rows * bound,
    }
