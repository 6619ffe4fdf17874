"""ElasticDiffusion text-to-image, plainly: one denoise step as the program
defines it, on the reference models of ``models.py``.

A frozen copy of the program's plain code (``core/pipeline.py``,
``core/signals.py``, ``core/background.py``, ``ops/views.py``,
``ops/resample.py``, ``ops/resize.py``, ``sched/ddim.py``,
``sched/weight_schedulers.py``), kept here so that a change of the program
cannot move its own yardstick. What it keeps of the program is the
algorithm and its random draws, seed for seed and call for call: the same
``torch.Generator`` seeds, draw shapes and draw order, so that on the same
device both draw the same numbers. What it leaves out: the mesh, scripted
noise, checkpoints, the image log. Every UNet input stays float32.

One step (``Request.step``): the global direction from 2(rs+1) CFG forwards
at the downsampled size (randomised resampling, background pads), the local
unconditional score from V patch views, a DDIM update, with repaint the
re-noising and a second estimate (2 + V forwards), and the reduced-resolution
guidance while its weight is over 10.

With a ControlNet (a configuration with a ``controlnet`` block, a request
with a condition image), every UNet forward first runs the ControlNet on
the same rows and adds its residuals. The condition is resized to the
downsampled size in pixels, as the program's ``_context`` does; the
direction zero-pads it by the background pads in pixels and lays it out as
its latents (``signals.approximate_latent_direction``); the local signal
upsamples it to the full latent's pixels and crops it per view
(``signals.view_conditions``); repaint's second estimate takes the same.
"""

from __future__ import annotations

import hashlib
import math
from dataclasses import dataclass
from fractions import Fraction
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from . import models as M
from .tokenizer import tokenize


def fold(seed: int, n: int) -> int:
    """A sub-seed of `seed`, one per purpose (the program's ``_fold``)."""
    return (int(seed) * 1000003 + n) % (2 ** 63)


# ---------------------------------------------------------------------------
# nearest resize
# ---------------------------------------------------------------------------


def nearest_indices(in_size: int, out_size: int) -> np.ndarray:
    idx = np.floor(np.arange(out_size) * (in_size / out_size)).astype(np.int64)
    return np.minimum(idx, in_size - 1)


def nearest_resize(x: torch.Tensor, size) -> torch.Tensor:
    H, W = int(size[0]), int(size[1])
    if tuple(x.shape[-2:]) == (H, W):
        return x
    rows = torch.from_numpy(nearest_indices(x.shape[-2], H)).to(x.device)
    cols = torch.from_numpy(nearest_indices(x.shape[-1], W)).to(x.device)
    return x.index_select(-2, rows).index_select(-1, cols)


# ---------------------------------------------------------------------------
# patch views
# ---------------------------------------------------------------------------


def get_views_latent(H: int, W: int, h_ws: int, w_ws: int, stride: int):
    nbh = math.ceil((H - h_ws) / stride) + 1 if stride else 1
    nbw = math.ceil((W - w_ws) / stride) + 1 if stride else 1
    views = []
    for i in range(int(nbh * nbw)):
        h0 = int((i // nbw) * stride)
        h1 = h0 + h_ws
        if h1 > H:
            h0, h1 = max(0, h0 - (h1 - H)), H
        w0 = int((i % nbw) * stride)
        w1 = w0 + w_ws
        if w1 > W:
            w0, w1 = max(0, w0 - (w1 - W)), W
        views.append((h0, h1, w0, w1))
    return views


def _context_lines(start: int, end: int, limit: int, n: int):
    if start - n < 0:
        before = np.arange(max(0, start - n), start)
        after = np.arange(end, min(limit, end + 2 * n - len(before)))
    else:
        after = np.arange(end, min(limit, end + n))
        before = np.arange(max(0, start - (2 * n - len(after))), start)
    return before, after


@dataclass
class ViewPlan:
    rows: torch.Tensor        # (V, out_h)
    cols: torch.Tensor        # (V, out_w)
    owner_view: torch.Tensor  # (H, W)
    owner_y: torch.Tensor
    owner_x: torch.Tensor

    @property
    def num_views(self) -> int:
        return self.rows.shape[0]

    @property
    def out_shape(self) -> Tuple[int, int]:
        return self.rows.shape[1], self.cols.shape[1]


def build_view_plan(H: int, W: int, sample_size: int, device) -> ViewPlan:
    """Windows of sample_size // 2 latent pixels at that stride, each with
    sample_size // 4 lines of context a side (rebalanced at the borders);
    an axis whose window and context cover it whole is one window. The
    lowest view that covers a pixel owns it."""
    ws = sample_size // 2
    ctx = sample_size - ws
    h_ws = H if ws + ctx >= H else ws
    w_ws = W if ws + ctx >= W else ws
    views = get_views_latent(H, W, h_ws, w_ws, ws)
    n = ctx // 2
    rows, cols, tops, lefts = [], [], [], []
    for (a, b, c, d) in views:
        top, bottom = _context_lines(a, b, H, n)
        left, right = _context_lines(c, d, W, n)
        rows.append(np.concatenate([top, np.arange(a, b), bottom]))
        cols.append(np.concatenate([left, np.arange(c, d), right]))
        tops.append(len(top))
        lefts.append(len(left))
    owner = np.full((H, W), -1, dtype=np.int64)
    oy = np.zeros((H, W), dtype=np.int64)
    ox = np.zeros((H, W), dtype=np.int64)
    for v, (a, b, c, d) in enumerate(views):
        yy, xx = np.nonzero(owner[a:b, c:d] == -1)
        owner[a:b, c:d][yy, xx] = v
        oy[a:b, c:d][yy, xx] = tops[v] + yy
        ox[a:b, c:d][yy, xx] = lefts[v] + xx
    if (owner < 0).any():
        raise ValueError("views do not tile the latent")
    t = lambda a: torch.from_numpy(np.asarray(a, dtype=np.int64)).to(device)
    return ViewPlan(t(np.stack(rows)), t(np.stack(cols)), t(owner), t(oy), t(ox))


# ---------------------------------------------------------------------------
# randomised rational downsampling
# ---------------------------------------------------------------------------


def to_even_rational(f: float, max_block: int = 32) -> Tuple[int, int]:
    frac = Fraction(f).limit_denominator(max_block)
    if frac.numerator % 2 or frac.denominator % 2:
        frac = Fraction(f).limit_denominator(max_block // 2)
    if frac.numerator % 2 or frac.denominator % 2:
        return frac.numerator * 2, frac.denominator * 2
    return frac.numerator, frac.denominator


def _keep_blocks(block: int, n_remove: int):
    pairs = n_remove // 2
    mask = np.ones(block, dtype=bool)
    interval = block // (pairs + 1)
    if interval % 2:
        interval += 1
    split = []
    for i in range(pairs):
        start = (i + 1) * interval - 1
        split.extend([start - 1 - i * 2, start + 2 - (i + 1) * 2])
        mask[start:start + 2] = False
    return np.nonzero(mask)[0], np.asarray(split, dtype=np.int64)


def _restore_row_of(n_kept: int, splits: np.ndarray) -> np.ndarray:
    row_of = np.zeros(n_kept, dtype=np.int64)
    A = [int(s) for s in splits]
    i = j = out = 0
    while i < n_kept:
        if j < len(A) and i == A[j]:
            row_of[i] = out
            if i + 1 < n_kept:
                row_of[i + 1] = out + 1
            out += 2
            j += 2
        else:
            row_of[i] = out
            if i + 1 < n_kept:
                row_of[i + 1] = out
            out += 1
        i += 2
    return row_of


def _axis_plan(in_size: int, out_size: int):
    n_keep, block = to_even_rational(out_size / in_size)
    n_blocks = (out_size * 2) // n_keep
    if n_blocks * block > in_size * 2:
        n_blocks -= 1
    extent = n_blocks * block
    offsets, masked = _keep_blocks(block, block - n_keep)
    kept = (np.arange(0, extent, block)[:, None] + offsets).ravel()
    kept = kept[kept < in_size * 2]
    remain = out_size * 2 - len(kept)
    kept = np.concatenate([kept, np.arange(extent, min(extent + max(remain, 0),
                                                       in_size * 2))])
    if len(kept) % 2:
        raise ValueError(f"odd keep count for {in_size} -> {out_size}")
    if len(masked):
        splits = (np.arange(0, out_size * 2, n_keep)[:, None] + masked).ravel()
    else:
        splits = np.asarray([], dtype=np.int64)
    mask_of = _restore_row_of(len(kept), splits)
    return kept // 2, np.where(mask_of < in_size, mask_of, in_size)


@dataclass
class ResamplePlan:
    in_h: int
    in_w: int
    out_h: int
    out_w: int
    row_src: torch.Tensor
    col_src: torch.Tensor
    row_mask_of: torch.Tensor
    col_mask_of: torch.Tensor

    @property
    def num_blocks(self) -> int:
        return self.out_h * self.out_w


def build_resample_plan(H: int, W: int, h: int, w: int, device) -> ResamplePlan:
    rs, rm = _axis_plan(H, h)
    cs, cm = _axis_plan(W, w)
    t = lambda a: torch.from_numpy(np.asarray(a, dtype=np.int64)).to(device)
    return ResamplePlan(H, W, len(rs) // 2, len(cs) // 2, t(rs), t(cs), t(rm), t(cm))


def downsample_size(H: int, W: int, native: int, vsf: int) -> Tuple[int, int]:
    f = max(max(H, W) / native, 1)
    return int((H // f) // vsf), int((W // f) // vsf)


def sample_pick_indices(gen, excl, n):
    dev = gen.device
    u = torch.rand((n, 4), generator=gen, device=dev)
    pick = torch.where(excl, -1.0, u).argmax(dim=1)
    fallback = torch.randint(0, 4, (n,), generator=gen, device=dev)
    return torch.where(excl.all(dim=1), fallback, pick)


def mix_with_prev(gen, new, prev, drop_p: float):
    keep = torch.rand(new.shape, generator=gen, device=gen.device) < drop_p
    return torch.where(keep, prev, new)


def resolve_picks(gen, n_sub: int, n: int, drop_p: float) -> torch.Tensor:
    """Every substep's pick: substep 0 the top-left pixel, later ones fresh
    picks avoiding those used, each kept from the previous substep with
    probability drop_p. Draws rand, randint, rand per substep."""
    dev = gen.device
    excl = torch.zeros((n, 4), dtype=torch.bool, device=dev)
    prev = torch.zeros((n,), dtype=torch.int64, device=dev)
    picks = []
    for s in range(n_sub):
        mixed = mix_with_prev(gen, sample_pick_indices(gen, excl, n), prev, drop_p)
        pick = torch.zeros_like(prev) if s == 0 else mixed
        excl = excl.clone()
        excl[torch.arange(n, device=dev), pick] = True
        prev = pick
        picks.append(pick)
    return torch.stack(picks)


def apply_resample(latent, plan: ResamplePlan, pick):
    dev = latent.device
    h, w = plan.out_h, plan.out_w
    r = pick.to(device=dev, dtype=torch.int64).reshape(h, w)
    roff, coff = r // 2, r % 2
    ky = 2 * torch.arange(h, device=dev)[:, None] + roff
    kx = 2 * torch.arange(w, device=dev)[None, :] + coff
    down = latent[:, :, plan.row_src[ky], plan.col_src[kx]]
    kk = torch.arange(2 * h, device=dev)[:, None]
    ll = torch.arange(2 * w, device=dev)[None, :]
    kept = (roff[kk // 2, ll // 2] == kk % 2) & (coff[kk // 2, ll // 2] == ll % 2)
    mrow = plan.row_mask_of[:, None].expand(2 * h, 2 * w)
    mcol = plan.col_mask_of[None, :].expand(2 * h, 2 * w)
    hits = torch.zeros((plan.in_h + 1, plan.in_w + 1), dtype=torch.int32, device=dev)
    hits.index_put_((mrow, mcol), kept.to(torch.int32), accumulate=True)
    return down, hits[:plan.in_h, :plan.in_w] > 0


# ---------------------------------------------------------------------------
# background pads
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class PadSpec:
    in_h: int
    in_w: int
    min_h: int
    min_w: int

    @property
    def pads(self):
        hp, wp = max(self.min_h - self.in_h, 0), max(self.min_w - self.in_w, 0)
        return wp // 2, wp - wp // 2, hp // 2, hp - hp // 2

    @property
    def needs_padding(self) -> bool:
        return any(p > 0 for p in self.pads)

    def sides(self) -> Dict[str, Tuple[int, int]]:
        l, r, t, b = self.pads
        out = {}
        if l:
            out["3_1"] = (self.in_h, l)
        if r:
            out["3_2"] = (self.in_h, r)
        if t:
            out["2_1"] = (t, self.in_w + l + r)
        if b:
            out["2_2"] = (b, self.in_w + l + r)
        return out


def pad_with_background(x, spec: PadSpec, bgs):
    if not spec.needs_padding:
        return x
    rep = lambda a: a.to(x.dtype)[None].expand(x.shape[0], *a.shape)
    l, r, t, b = spec.pads
    if l:
        x = torch.cat([rep(bgs["3_1"]), x], dim=3)
    if r:
        x = torch.cat([x, rep(bgs["3_2"])], dim=3)
    if t:
        x = torch.cat([rep(bgs["2_1"]), x], dim=2)
    if b:
        x = torch.cat([x, rep(bgs["2_2"])], dim=2)
    return x


def crop_from_padding(x, spec: PadSpec):
    l, r, t, b = spec.pads
    return x[..., t:x.shape[-2] - b, l:x.shape[-1] - r]


# ---------------------------------------------------------------------------
# DDIM and the RRG weights
# ---------------------------------------------------------------------------


class DDIM:
    """diffusers DDIM as Stable Diffusion configures it: scaled_linear
    betas 0.00085 .. 0.012 over 1000 steps, 'leading' spacing with offset 1,
    set_alpha_to_one False, epsilon prediction, eta 0."""

    T = 1000

    def __init__(self):
        self.betas = np.linspace(0.00085 ** 0.5, 0.012 ** 0.5, self.T,
                                 dtype=np.float64) ** 2
        self.abar = np.cumprod(1.0 - self.betas)

    def timesteps(self, n: int) -> np.ndarray:
        ts = (np.arange(0, n) * (self.T // n)).round()
        return ts[::-1].copy().astype(np.int64) + 1

    def coeffs(self, ts: np.ndarray) -> np.ndarray:
        n = len(ts)
        rows = []
        for i in range(n):
            t = min(int(ts[i]), self.T - 1)
            prev = t - self.T // n
            a = float(self.abar[t])
            ap = float(self.abar[prev]) if prev >= 0 else float(self.abar[0])
            rows.append((a ** 0.5, (1 - a) ** 0.5, ap ** 0.5, (1 - ap) ** 0.5))
        return np.asarray(rows, dtype=np.float32)

    def add_noise_coeffs(self, t: int):
        a = float(self.abar[int(t)])
        return a ** 0.5, (1 - a) ** 0.5

    def undo_coeffs(self, n_steps: int, t: int):
        n = self.T // n_steps
        ts = [int(t) + i for i in range(n) if int(t) + i < self.T]
        b = self.betas[np.asarray(ts, dtype=np.int64)]
        return np.sqrt(1.0 - b).astype(np.float32), np.sqrt(b).astype(np.float32)


def ddim_step(eps, x, coeffs):
    sa, s1a, sap, s1ap = (float(c) for c in coeffs)
    x0 = (x - s1a * eps) / sa
    return sap * x0 + s1ap * eps, x0


def rrg_weights(n: int, stop_t: float, init: float, cosine_scale: float,
                kind: str = "cosine") -> np.ndarray:
    steps = n - int(n * stop_t)

    def w(t):
        if t >= steps:
            return 0.0
        if kind == "cosine":
            return init * (0.5 * (1 + np.cos(np.pi * t / steps))) ** cosine_scale
        if kind == "linear":
            return init + (0.0 - init) / steps * t
        return init
    return np.asarray([float(w(i)) for i in range(n)], dtype=np.float32)


# ---------------------------------------------------------------------------
# one request
# ---------------------------------------------------------------------------


class Models:
    """The reference models of one configuration on a device, computing as
    the precisions of `precs` say: {'unet', 'text_encoder', 'vae_decode',
    'vae_encode', and with a ControlNet 'controlnet'} ->
    ``models.Precision``."""

    def __init__(self, cfg: dict, sd: Dict[str, dict], device,
                 precs: Dict[str, M.Precision], rows: int = 4):
        self.cfg, self.device, self.rows = cfg, device, rows
        self.prec, self.text_prec = precs["unet"], precs["text_encoder"]
        self.dec_prec, self.enc_prec = precs["vae_decode"], precs["vae_encode"]
        self.unet = M.materialise(M.build("unet", cfg["unet"]), sd["unet"],
                                  device, self.prec)
        self.vae_dec = M.materialise(M.build("vae", cfg["vae"]), sd["vae"],
                                     device, self.dec_prec)
        self.vae_enc = self.vae_dec if self.enc_prec.mode == self.dec_prec.mode \
            else M.materialise(M.build("vae", cfg["vae"]), sd["vae"], device,
                               self.enc_prec)
        self.text = [M.materialise(M.build("clip", c), sd[name], device,
                                   self.text_prec)
                     for name, c in text_encoders(cfg)]
        self.controlnet = None
        if "controlnet" in cfg:
            self.cn_prec = precs["controlnet"]
            self.controlnet = M.materialise(
                M.build("controlnet", cfg["controlnet"]), sd["controlnet"],
                device, self.cn_prec)

    @torch.no_grad()
    def text_embeds(self, prompts: List[str]):
        """(text embeddings, pooled): SDXL joins both encoders' penultimate
        states and pools with the second; the others take the last state."""
        encs = text_encoders(self.cfg)
        outs = []
        for i, (model, (_, c)) in enumerate(zip(self.text, encs)):
            pad = 0 if (self.cfg["is_xl"] and i == 1) else None
            ids = torch.from_numpy(tokenize(prompts, c["vocab_size"], pad)).to(self.device)
            with self.text_prec:
                outs.append(model(ids, self.text_prec))
        if self.cfg["is_xl"]:
            return torch.cat([outs[0][1], outs[1][1]], dim=-1), outs[1][2]
        return outs[0][0], outs[0][0]

    @torch.no_grad()
    def unet_fn(self, x, t, ctx, add_text=None, add_tid=None, cond=None,
                scale: float = 1.0):
        """The UNet over a batch; with a condition `cond` (one a row), each
        block of rows first through the ControlNet."""
        if cond is None:
            with self.prec:
                return M.unet_rows(self.unet, x, t, ctx, self.prec, add_text,
                                   add_tid, self.rows)
        outs = []
        for lo in range(0, x.shape[0], self.rows):
            sl = slice(lo, lo + self.rows)
            at = None if add_text is None else add_text[sl]
            tid = None if add_tid is None else add_tid[sl]
            with self.cn_prec:
                down, mid = self.controlnet(x[sl], t, ctx[sl], cond[sl], scale,
                                            self.cn_prec, at, tid)
            with self.prec:
                outs.append(self.unet(x[sl], t, ctx[sl], self.prec, at, tid,
                                      down, mid))
        return torch.cat(outs)

    @torch.no_grad()
    def encode_sample(self, img, noise):
        with self.enc_prec:
            return self.vae_enc.encode_sample(img, noise, self.enc_prec)

    @torch.no_grad()
    def decode_image(self, latent) -> torch.Tensor:
        """The program's ``decode_latents``: (img / 2 + 0.5) clamped to
        [0, 1], image by image."""
        z = latent.float() / self.cfg["vae"]["scaling_factor"]
        with self.dec_prec:
            imgs = [self.vae_dec.decode(z[i:i + 1], self.dec_prec)
                    for i in range(z.shape[0])]
        return (torch.cat(imgs) / 2 + 0.5).clamp(0.0, 1.0)


def text_encoders(cfg: dict):
    """[(state dict name, config)] of the configuration's text encoders."""
    names = ["text_encoder", "text_encoder_2"]
    return [(n, cfg[n]) for n in names if n in cfg]


class Request:
    """One generate_image call, plainly: its plans, text conditioning,
    schedule and generators, built as the program builds them from the
    same seed, prompt and parameters; ``step`` is one denoise step.
    `condition` (1, 3, h, w) in [0, 1] is the ControlNet's condition image,
    taken at `scale` (the traffic's ``controlnet_conditioning_scale``)."""

    def __init__(self, models: Models, traffic: dict, steps: int, seed: int,
                 prompt: str, negative: str, condition=None, scale: float = 1.0):
        cfg = models.cfg
        dev = models.device
        self.m, self.dev = models, dev
        H, W = traffic["height"], traffic["width"]
        vsf = 2 ** (len(cfg["vae"]["block_out_channels"]) - 1)
        self.lat_h, self.lat_w = H // vsf, W // vsf
        sample = cfg["unet"]["sample_size"]
        m = cfg["min_latent_size"]
        dh, dw = downsample_size(H, W, cfg["native_resolution"], vsf)
        self.plan = build_resample_plan(self.lat_h, self.lat_w, dh, dw, dev)
        self.views = build_view_plan(self.lat_h, self.lat_w, sample, dev)
        self.down_pad = PadSpec(self.plan.out_h, self.plan.out_w, m, m)
        self.view_pad = PadSpec(*self.views.out_shape, m, m)
        self.vsf, self.cond, self.cn_scale = vsf, None, float(scale)
        if condition is not None:
            self.cond = nearest_resize(condition.to(dev, torch.float32),
                                       (self.plan.out_h * vsf, self.plan.out_w * vsf))
        self.g = float(traffic["guidance_scale"])
        self.rs = int(traffic["resampling_steps"])
        self.drop_p = 1 - float(traffic["new_p"])
        self.T = steps
        uncond, upool = models.text_embeds([negative])
        cond, cpool = models.text_embeds([prompt])
        self.text_cfg, self.uncond = torch.cat([uncond, cond]), uncond
        self.add_text = self.tid = self.upool = None
        if cfg["is_xl"]:
            self.add_text = torch.cat([upool, cpool])
            s = (4 * H, 4 * W)
            self.tid = torch.tensor([[*s, 0, 0, *s]], dtype=torch.float32, device=dev)
            self.upool = upool
        self.gen = torch.Generator(device=dev).manual_seed(fold(seed, 3))
        self.seed = seed
        ddim = DDIM()
        self.ts = ddim.timesteps(steps)
        self.coeffs = ddim.coeffs(self.ts)
        self.rrg_w = rrg_weights(steps, traffic["rrg_stop_t"],
                                 traffic["rrg_init_weight"], traffic["cosine_scale"])
        self.repaint = bool(traffic.get("repaint_sampling", True)) and self.rs > 0
        self.undo = [ddim.undo_coeffs(steps, int(self.ts[i + 1]))
                     for i in range(steps - 1)] if self.repaint else []
        bg = fold(seed, 2)
        self.bg_down = self._backgrounds(self.down_pad, bg, ddim)
        self.bg_view = self._backgrounds(self.view_pad, fold(bg, 1), ddim)

    def initial_latent(self) -> torch.Tensor:
        gen = torch.Generator(device=self.dev).manual_seed(fold(self.seed, 1))
        C = self.m.cfg["unet"]["in_channels"]
        return torch.randn((1, C, self.lat_h, self.lat_w), generator=gen, device=self.dev)

    def _backgrounds(self, spec: PadSpec, seed: int, ddim: DDIM):
        """{side: (T, C, ph, pw)}: a solid random colour, VAE-encoded and
        noised to each timestep; one generator per (seed, side, t)."""
        cfg = self.m.cfg
        vsf = 2 ** (len(cfg["vae"]["block_out_channels"]) - 1)
        C = cfg["vae"]["latent_channels"]
        tables = {}
        for side, (ph, pw) in spec.sides().items():
            sid = int(hashlib.md5(f"{side}_{ph}_{pw}".encode()).hexdigest()[:8], 16)
            rows = []
            for t in self.ts:
                t = int(t)
                gen = torch.Generator(device=self.dev).manual_seed(
                    (int(seed) * 1000003 + sid * 1009 + t) % (2 ** 63))
                color = torch.rand((1, 3, 1, 1), generator=gen, device=self.dev)
                color = color.expand(1, 3, ph * vsf, pw * vsf)
                noise = torch.randn((1, C, ph, pw), generator=gen, device=self.dev)
                z = self.m.encode_sample(2.0 * color - 1.0, noise) \
                    * cfg["vae"]["scaling_factor"]
                n2 = torch.randn(z.shape, generator=gen, device=self.dev)
                a, b = ddim.add_noise_coeffs(t)
                rows.append((a * z + b * n2)[0])
            tables[side] = torch.stack(rows)
        return tables

    def _unet(self, x, t, pad: PadSpec, bgs, ctx, add_text, tid, cond=None):
        eps = self.m.unet_fn(pad_with_background(x, pad, bgs), t, ctx, add_text,
                             tid, cond, self.cn_scale)
        return crop_from_padding(eps, pad)

    def _direction_conditions(self, n: int):
        """The condition zero-padded by the direction's background pads in
        pixels, once for each of the `n` rows of its UNet call."""
        if self.cond is None:
            return None
        f = self.vsf
        l, r, t, b = self.down_pad.pads
        return F.pad(self.cond, (l * f, r * f, t * f, b * f)).repeat(n, 1, 1, 1)

    def _view_conditions(self):
        """The condition of every view: nearest-upsampled to the full
        latent's pixels, cropped with the view plan's rows and columns in
        pixels (each latent index i giving pixels i f .. i f + f - 1)."""
        if self.cond is None:
            return None
        v, f = self.views, self.vsf
        up = nearest_resize(self.cond[:1], (self.lat_h * f, self.lat_w * f))
        sub = torch.arange(f, device=up.device)
        rows = (v.rows[:, :, None] * f + sub).reshape(v.num_views, -1)
        cols = (v.cols[:, :, None] * f + sub).reshape(v.num_views, -1)
        return up[0][:, rows[:, :, None], cols[:, None, :]].permute(1, 0, 2, 3)

    def _direction(self, lat, t, bgs, n_sub):
        """(direction (1, C, H, W), last substep's downsampled latent,
        its unconditional eps, the direction downsampled)."""
        plan = self.plan
        picks = resolve_picks(self.gen, n_sub, plan.num_blocks, self.drop_p)
        pairs = [apply_resample(lat, plan, picks[s]) for s in range(n_sub)]
        downs = torch.stack([p[0] for p in pairs])
        B, C = lat.shape[:2]
        dh, dw = plan.out_h, plan.out_w
        flat = downs.reshape(n_sub * B, C, dh, dw)
        x2 = torch.cat([flat, flat])
        u, c = self.text_cfg[:B], self.text_cfg[B:]
        ctx = torch.cat([u.repeat(n_sub, 1, 1), c.repeat(n_sub, 1, 1)])
        ate = tid = None
        if self.add_text is not None:
            au, ac = self.add_text[:B], self.add_text[B:]
            ate = torch.cat([au.repeat(n_sub, 1), ac.repeat(n_sub, 1)])
            tid = self.tid.expand(2 * n_sub * B, 6)
        eps = self._unet(x2, t, self.down_pad, bgs, ctx, ate, tid,
                         self._direction_conditions(2 * n_sub * B)).float()
        eu = eps[:n_sub * B].reshape(n_sub, B, C, dh, dw)
        ec = eps[n_sub * B:].reshape(n_sub, B, C, dh, dw)
        dirs = ec - eu
        H, W = lat.shape[-2:]
        target = torch.zeros((B, C, H, W), device=lat.device)
        filled = torch.zeros((H, W), dtype=torch.bool, device=lat.device)
        for s in range(n_sub):
            target = torch.where(pairs[s][1], nearest_resize(dirs[s], (H, W)), target)
            filled = filled | pairs[s][1]
        target = torch.where(filled, target, nearest_resize(dirs[-1], (H, W)))
        return target, downs[-1], eu[-1], nearest_resize(target, (dh, dw))

    def _local(self, lat, t, bgs):
        v = self.views
        V = v.num_views
        views = lat[:, :, v.rows[:, :, None], v.cols[:, None, :]].permute(2, 0, 1, 3, 4)
        vb = views.reshape(V * lat.shape[0], *views.shape[2:])
        ctx = self.uncond.repeat(V, 1, 1)
        pooled = tid = None
        if self.upool is not None:
            pooled = self.upool.repeat(V, 1)
            tid = self.tid.expand(V, 6)
        preds = self._unet(vb, t, self.view_pad, bgs, ctx, pooled, tid,
                           self._view_conditions())
        preds = preds.reshape(V, lat.shape[0], *preds.shape[1:]).float()
        return preds[v.owner_view, :, :, v.owner_y, v.owner_x].permute(2, 3, 0, 1)

    def _estimate(self, lat, i, n_sub):
        t = float(self.ts[i])
        bd = {s: tbl[i] for s, tbl in self.bg_down.items()}
        bv = {s: tbl[i] for s, tbl in self.bg_view.items()}
        return self._direction(lat, t, bd, n_sub), self._local(lat, t, bv)

    @torch.no_grad()
    def step(self, i: int, lat: torch.Tensor) -> torch.Tensor:
        """Denoise step i from `lat`, drawing from the request's generator."""
        coeffs = self.coeffs[i]
        (d, dlat, eu, ddir), local = self._estimate(lat, i, self.rs + 1)
        prev, x0 = ddim_step(local + self.g * d, lat.float(), coeffs)
        g = self.g
        if i < len(self.undo):
            s1mb, sb = self.undo[i]
            lat2 = prev
            for a, b in zip(s1mb, sb):
                n = torch.randn(prev.shape, generator=self.gen, dtype=prev.dtype,
                                device=prev.device)
                lat2 = float(a) * lat2 + float(b) * n
            (d, dlat, eu, ddir), local = self._estimate(lat2, i, 1)
            g = self.g / 3
            prev, x0 = ddim_step(local + g * d, lat2.float(), coeffs)
        w = float(self.rrg_w[i])
        if w <= 10.0:
            return prev
        _, ref_x0 = ddim_step(eu + g * ddir, dlat, coeffs)
        up = nearest_resize(ref_x0, x0.shape[-2:])
        numel = x0.shape[1] * x0.shape[2] * x0.shape[3]
        return prev + 2.0 * w * (up - x0) / numel

    def skip_draws(self, i: int, shape) -> None:
        """Advance the generator past step i's draws without computing it."""
        n = self.plan.num_blocks
        resolve_picks(self.gen, self.rs + 1, n, self.drop_p)
        if i < len(self.undo):
            for _ in self.undo[i][0]:
                torch.randn(shape, generator=self.gen, dtype=torch.float32,
                            device=self.dev)
            resolve_picks(self.gen, 1, n, self.drop_p)
