"""Large-size VAE decode: the decoder split in two stages.

Counterpart of ``elasticdiffusion_tpu/parallel/halo_decode.py``. The
decoder's one global operation, the mid-block attention, runs in stage a at
latent resolution (``AutoencoderKL.decode_stage_a``), once on the whole
latent. Stage b, the 8x upsampling stack, is convolutions and GroupNorms:
each 3x3 conv sees one row above and below, and GroupNorm needs the moments
of the whole tensor. ``halo_decode`` runs stage b in one of four ways:

  mesh        a ``parallel/sharding.py`` mesh whose 'views' axis n > 1
              divides the latent's rows: rank i runs stage b on latent rows
              [i H/n, (i+1) H/n) of stage a's output (every rank runs stage
              a on the whole latent). Before every 3x3 conv each band
              ``all_gather``s its first and last rows over 'views' and takes
              its neighbours' (zeros at a true image edge, the conv's own
              padding), then convolves without H padding. Every GroupNorm
              takes its band's ``group_norm_sums``, ``all_reduce``s them
              over 'views' and normalises the band with
              ``group_norm_apply``: the bands are disjoint, so the moments
              are the whole tensor's and the result is exact. The x2
              upsample stays in the band; the bands are ``all_gather``ed
              into the whole image on every rank. The JAX package's
              ``shard_map`` branch, with ``all_gather`` in the place of
              ``ppermute``.
  monolithic  ``decode_stage_b`` on the whole tensor (``num_bands=1``).
  bands       ``num_bands > 1``: bands of latent rows, each widened by
              ``halo`` rows on both sides and decoded by the module on its
              own, the widened rows cut off. GroupNorm then takes each
              band's moments: an approximation, kept for comparison.
  streamed    ``streamed=True``: exact at any size. Only the resnets' inputs
              and outputs are stored whole; every norm, SiLU and conv runs
              one window of rows at a time. GroupNorm's moments of a stored
              tensor come from ``group_norm_sums`` over all of it, those of
              the x2-upsampled tensor between two up blocks (which is never
              stored: each window of it is recomputed from the
              pre-upsample tensor) from ``group_norm_sums`` window by
              window; ``group_norm_apply`` normalises each window with them.
              The convs are ``layers.conv2d`` with the modules' own
              weights.

Without the mesh branch, and with ``num_bands`` and ``streamed`` both
None, the choice is predictive:
monolithic up to ``MAX_PX`` output pixels, streamed above. No branch is
tried and abandoned on an out-of-memory error.

Conv padding in the streamed branch: a window is clamped to real rows and
the conv pads it with zeros, and its output rows are taken at their offset
in the window; so the zero padding is used exactly at a true image edge,
and the halo rows stand in for it elsewhere. Padding the raw input with
zero rows instead would be wrong: the monolithic decoder pads after
GroupNorm and SiLU, and gn(0) is not 0.

Windows of rows of a ``channels_last`` (1, C, H, W) tensor are contiguous,
so the kernels read them in place; the pipeline decodes one image at a
time. An fp32 decode runs with TF32 off (the caller's ``_fp32_convs``).
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels.groupnorm import group_scale_shift, moment_sums, scale_shift
from ..models.layers import conv2d
from .sharding import (all_gather_views, all_reduce_views, views_rank,
                       views_size)

DEFAULT_HALO = 16  # bands: the receptive field of stage b is ~13 latent rows

# The streamed branch's slab budget: a window of rows of one image holds at
# most CHUNK_BYTES of fp32 (B, rows, W, C). The fp32 SDXL decode at
# 2048x2048 px streamed in 3.248, 2.213, 1.947, 1.903 and 1.893 s at 16 MB,
# 64 MB, 256 MB, 1 GB and 4 GB, peaking at 7.70, 7.83, 8.33, 10.91 and
# 26.98 GB above the resident bundle; 256 MB is within 3 % of the fastest
# for 2.6 GB less than 1 GB takes (chip_smoke.py --phases decode
# --chunk-budgets, NVIDIA H100 80GB HBM3, 700.00 W).
CHUNK_BYTES = 1 << 28

# Output pixels (of all images of one call) up to which the monolithic
# stage b is chosen: where its peak would reach DECODE_BUDGET, half of the
# card's 80 GB (the other half for the resident bundles, 7.4 GB for SDXL,
# and the caller's tensors). Peak bytes a pixel of the monolithic route
# above the resident bundle: 18,390,188,544 over 2048x2048 px in fp32
# (SDXL), 764,412,416 over 768x768 px in bf16 (SD 2.1); the streamed route
# took 1986 and 1175 (chip_smoke.py --phases decode, NVIDIA H100 80GB HBM3,
# 700.00 W). So fp32 decodes stream above about 3130x3130 px.
DECODE_BUDGET = 40 << 30
MONO_BYTES_PER_PX = {torch.float32: 4385, torch.bfloat16: 1296}
MAX_PX = {dt: DECODE_BUDGET // b for dt, b in MONO_BYTES_PER_PX.items()}

Read = Callable[[int, int], torch.Tensor]


def _row_chunk(H: int, W: int, C: int, B: int = 1) -> int:
    """Largest divisor of H whose (B, chunk, W, C) fp32 slab fits
    CHUNK_BYTES."""
    target = max(1, CHUNK_BYTES // (B * W * C * 4))
    return max(d for d in range(1, H + 1) if H % d == 0 and d <= target)


def _stored_read(x: torch.Tensor) -> Read:
    return lambda start, n: x[:, :, start:start + n]


def _upsample_read(x_small: torch.Tensor, conv) -> Read:
    """Rows [start, start + n) of conv3x3(upsample_x2(x_small)), recomputed
    from the x_small rows they need, so that the upsampled tensor never
    exists. `start` must be clamped to [0, 2 Hs - n] by the caller."""
    Hs = x_small.shape[2]

    def read(start: int, n: int) -> torch.Tensor:
        ks = min(n // 2 + 2, Hs)
        s2 = min(max((start - 1) // 2, 0), Hs - ks)
        up = F.interpolate(x_small[:, :, s2:s2 + ks], scale_factor=2.0,
                           mode="nearest")
        o = conv2d(up, conv.weight, conv.bias, padding=1)
        # the conv's zero rows at the window's ends are selected only where
        # the window is clamped against a true image edge
        return o[:, :, start - 2 * s2:start - 2 * s2 + n]

    return read


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def _moments(gn, sums: torch.Tensor, rows: int):
    return group_scale_shift(sums, rows, gn.weight, gn.bias, gn.groups, gn.eps)


def _stored_moments(gn, x: torch.Tensor):
    """(scale, shift) of GroupNorm `gn` over a stored tensor."""
    sums = moment_sums(_nhwc(x), gn.use_kernels)
    return _moments(gn, sums, x.shape[2] * x.shape[3])


def _read_moments(gn, read: Read, shape, chunk: int):
    """(scale, shift) of GroupNorm `gn` over a virtual tensor: its sums
    window by window, added in row order."""
    B, C, H, W = shape
    sums = None
    for i in range(H // chunk):
        s = moment_sums(_nhwc(read(i * chunk, chunk)), gn.use_kernels)
        sums = s if sums is None else sums + s
    return _moments(gn, sums, H * W)


def _nsc_streamed(read: Read, shape, gn, moments, conv, chunk: int,
                  skip_read: Optional[Read] = None) -> torch.Tensor:
    """GroupNorm (with the whole input's moments), SiLU and a 3x3 conv over
    an input read in windows of `chunk` + 2 rows. skip_read(start, n), if
    given, yields rows of the resnet's residual, added to each output
    window. Returns the stored (B, Cout, H, W) output, channels_last."""
    B, C, H, W = shape
    scale, shift = moments
    win = min(chunk + 2, H)
    out = torch.empty((B, conv.out_channels, H, W), dtype=conv.weight.dtype,
                      device=conv.weight.device,
                      memory_format=torch.channels_last)
    for i in range(H // chunk):
        r0 = i * chunk
        start = min(max(r0 - 1, 0), H - win)
        a = scale_shift(_nhwc(read(start, win)), scale, shift, True,
                        gn.use_kernels)
        o = conv2d(a.permute(0, 3, 1, 2), conv.weight, conv.bias,
                   padding=1)[:, :, r0 - start:r0 - start + chunk]
        if skip_read is not None:
            o = o + skip_read(r0, chunk)
        out[:, :, r0:r0 + chunk] = o
    return out


def _resnet_streamed(src, shape, resnet, chunk: int) -> torch.Tensor:
    """A VAE ResnetBlock2D over a stored tensor or a virtual read: only its
    middle tensor and its output are stored whole."""
    stored = torch.is_tensor(src)
    read = _stored_read(src) if stored else src
    m1 = (_stored_moments(resnet.norm1, src) if stored
          else _read_moments(resnet.norm1, read, shape, chunk))
    h = _nsc_streamed(read, shape, resnet.norm1, m1, resnet.conv1, chunk)
    sc = resnet.conv_shortcut
    skip = read if sc is None else (
        lambda start, n: conv2d(read(start, n), sc.weight, sc.bias))
    return _nsc_streamed(_stored_read(h), h.shape, resnet.norm2,
                         _stored_moments(resnet.norm2, h), resnet.conv2, chunk,
                         skip_read=skip)


def _stage_b_streamed(dec, hidden: torch.Tensor) -> torch.Tensor:
    """The decoder's stage b, exact, streamed in windows of rows."""
    B = hidden.shape[0]
    x = hidden
    for i, blk in enumerate(dec.up_blocks):
        if i == 0:
            src, shape = x, x.shape
        else:
            # the previous block's upsample, read without storing it
            src = _upsample_read(x, dec.up_blocks[i - 1].upsamplers[0].conv)
            shape = (B, x.shape[1], 2 * x.shape[2], 2 * x.shape[3])
        ch = blk.resnets[0].conv1.out_channels
        chunk = _row_chunk(shape[2], shape[3], max(shape[1], ch), B)
        x = _resnet_streamed(src, shape, blk.resnets[0], chunk)
        for resnet in blk.resnets[1:]:
            x = _resnet_streamed(x, x.shape, resnet, chunk)
    chunk = _row_chunk(x.shape[2], x.shape[3], x.shape[1], B)
    out = _nsc_streamed(_stored_read(x), x.shape, dec.conv_norm_out,
                        _stored_moments(dec.conv_norm_out, x), dec.conv_out,
                        chunk)
    return out.contiguous()


def _norm_band(x: torch.Tensor, gn, mesh) -> torch.Tensor:
    """GroupNorm `gn` (and its SiLU) of a band with the moments of all
    bands: the band's sums added over 'views'."""
    sums = all_reduce_views(moment_sums(_nhwc(x), gn.use_kernels), mesh)
    scale, shift = _moments(gn, sums, x.shape[2] * views_size(mesh)
                            * x.shape[3])
    return scale_shift(_nhwc(x), scale, shift, gn.silu,
                       gn.use_kernels).permute(0, 3, 1, 2)


def _conv_band(x: torch.Tensor, conv, mesh) -> torch.Tensor:
    """3x3 conv of a band: the row above it and the row below it from the
    neighbouring bands (zeros at a true image edge), no H padding."""
    n, r = views_size(mesh), views_rank(mesh)
    edges = all_gather_views(torch.cat([x[:, :, :1], x[:, :, -1:]], dim=2),
                             mesh)
    cl = torch.channels_last
    zero = torch.zeros_like(x[:, :, :1], memory_format=cl)
    top = edges[r - 1][:, :, 1:].contiguous(memory_format=cl) if r else zero
    bottom = edges[r + 1][:, :, :1].contiguous(memory_format=cl) \
        if r < n - 1 else zero
    return conv2d(torch.cat([top, x, bottom], dim=2), conv.weight,
                  conv.bias, padding=(0, 1))


def _resnet_band(x: torch.Tensor, resnet, mesh) -> torch.Tensor:
    h = _conv_band(_norm_band(x, resnet.norm1, mesh), resnet.conv1, mesh)
    h = _conv_band(_norm_band(h, resnet.norm2, mesh), resnet.conv2, mesh)
    if resnet.conv_shortcut is not None:
        x = resnet.conv_shortcut(x)
    return x + h


def _stage_b_mesh(dec, hidden: torch.Tensor, mesh) -> torch.Tensor:
    """The decoder's stage b on this rank's band of latent rows; the bands
    of the 'views' group joined into the whole image."""
    hs = hidden.shape[2] // views_size(mesh)
    r0 = views_rank(mesh) * hs
    x = hidden[:, :, r0:r0 + hs].contiguous(memory_format=torch.channels_last)
    for blk in dec.up_blocks:
        for resnet in blk.resnets:
            x = _resnet_band(x, resnet, mesh)
        if hasattr(blk, "upsamplers"):
            x = _conv_band(F.interpolate(x, scale_factor=2.0, mode="nearest"),
                           blk.upsamplers[0].conv, mesh)
    x = _conv_band(_norm_band(x, dec.conv_norm_out, mesh), dec.conv_out, mesh)
    return torch.cat(all_gather_views(x, mesh), dim=2)


def mesh_norm_shapes(vae_config, B: int, h: int, w: int, n: int
                     ) -> List[Tuple[str, Tuple[int, int, int, int], bool]]:
    """(half, (B, H, W, C), silu) of every launch of the two GroupNorm
    halves on one rank in the mesh stage b of a (B, 4, h, w) latent over n
    bands, in the order ``_stage_b_mesh`` makes them. Mirrors it: change
    both together."""
    bo = list(reversed(vae_config.block_out_channels))
    out = []

    def norm(H, W, C):
        out.extend([("sums", (B, H, W, C), False),
                    ("apply", (B, H, W, C), True)])

    H, W, C = h // n, w, bo[0]
    for i, ch in enumerate(bo):
        if i > 0:
            H, W = 2 * H, 2 * W
        for _ in range(vae_config.layers_per_block + 1):
            norm(H, W, C)
            norm(H, W, ch)
            C = ch
    norm(H, W, C)
    return out


def streamed_norm_shapes(vae_config, B: int, h: int, w: int
                         ) -> List[Tuple[str, Tuple[int, int, int, int], bool]]:
    """(half, (B, H, W, C), silu) of every launch of the two GroupNorm
    halves in the streamed stage b of a (B, 4, h, w) latent, in the order
    ``_stage_b_streamed`` makes them ('sums' with silu False). Mirrors it:
    change both together."""
    bo = list(reversed(vae_config.block_out_channels))
    out = []

    def nsc(H, W, C, chunk):
        for _ in range(H // chunk):
            out.append(("apply", (B, min(chunk + 2, H), W, C), True))

    H, W, C = h, w, bo[0]
    for i, ch in enumerate(bo):
        if i > 0:
            H, W = 2 * H, 2 * W
        chunk = _row_chunk(H, W, max(C, ch), B)
        for j in range(vae_config.layers_per_block + 1):
            if i > 0 and j == 0:  # moments of the virtual upsampled input
                out += [("sums", (B, chunk, W, C), False)] * (H // chunk)
            else:
                out.append(("sums", (B, H, W, C), False))
            nsc(H, W, C, chunk)
            out.append(("sums", (B, H, W, ch), False))
            nsc(H, W, ch, chunk)
            C = ch
    out.append(("sums", (B, H, W, C), False))
    nsc(H, W, C, _row_chunk(H, W, C, B))
    return out


def _bands(H: int, num_bands: int, halo: int) -> Tuple[int, int]:
    """(bands, rows a band decodes) of the band branch on H latent rows: the
    largest count up to `num_bands` that divides H, each band widened by
    `halo` rows a side within the latent."""
    n = max(1, min(num_bands, H))
    while H % n:
        n -= 1
    return n, min(H, H // n + 2 * halo)


def band_norm_shapes(vae_config, B: int, h: int, w: int, num_bands: int,
                     halo: int = DEFAULT_HALO
                     ) -> List[Tuple[Tuple[int, int, int, int], bool]]:
    """((B, H, W, C), silu) of every GroupNorm of the band branch of a
    (B, 4, h, w) latent, in the order ``_decode`` runs them: stage a's on
    the whole latent (the mid block's two resnets around its attention's
    norm), then stage b's for every band. Mirrors ``_decode`` and the
    decoder's modules: change them together."""
    bo = list(reversed(vae_config.block_out_channels))
    top = bo[0]
    out = [((B, h, w, top), True)] * 2 + [((B, h, w, top), False)] \
        + [((B, h, w, top), True)] * 2
    n, win = _bands(h, num_bands, halo)
    band = []
    H, W, C = win, w, top
    for i, ch in enumerate(bo):
        if i > 0:
            H, W = 2 * H, 2 * W
        for _ in range(vae_config.layers_per_block + 1):
            band += [((B, H, W, C), True), ((B, H, W, ch), True)]
            C = ch
    band.append(((B, H, W, C), True))
    return out + band * n


def choose_branch(dtype: torch.dtype, B: int, H: int, W: int, vsf: int) -> str:
    """'monolithic' or 'streamed': the default choice for a (B, 4, H, W)
    latent decoded in `dtype`."""
    out_px = B * (H * vsf) * (W * vsf)
    return "streamed" if out_px > MAX_PX[dtype] else "monolithic"


@torch.no_grad()
def halo_decode(bundle, latents_nchw: torch.Tensor, mesh=None,
                halo: int = DEFAULT_HALO, num_bands: Optional[int] = None,
                streamed: Optional[bool] = None, return_branch: bool = False):
    """(B, 4, H, W) latents (already divided by scaling_factor) -> (B, 3, 8H,
    8W) image in [-1, 1], on every rank of `mesh`. The exact mesh branch
    when the mesh's 'views' axis n > 1 divides H; else monolithic or
    streamed stage b by the predictive choice when `num_bands` and
    `streamed` are None; ``num_bands=1`` monolithic; ``num_bands > 1`` the
    approximate sequential bands (with `halo` latent rows of context a
    side); ``streamed=True`` the exact streamed stage b. The decoder runs in
    fp32 where the bundle's ``fp32_decode`` says so, as
    ``ModelBundle.vae_decode`` does, and in every dtype with TF32 off.
    `return_branch`: return (image, the branch taken: 'mesh',
    'monolithic', 'streamed' or 'bands')."""
    from ..models.registry import _fp32_convs
    with _fp32_convs():
        if bundle.fp32_decode:
            img, branch = _decode(bundle.vae_fp32, latents_nchw.float(),
                                  bundle.vae_scale_factor, halo, num_bands,
                                  streamed, mesh)
        else:
            img, branch = _decode(bundle.vae, latents_nchw,
                                  bundle.vae_scale_factor, halo, num_bands,
                                  streamed, mesh)
    return (img, branch) if return_branch else img


def _decode(vae, lat, vsf, halo, num_bands, streamed, mesh):
    """(image, branch) of ``halo_decode``."""
    B, _, H, W = lat.shape
    hidden = vae.decode_stage_a(lat)
    if views_size(mesh) > 1 and H % views_size(mesh) == 0:
        return _stage_b_mesh(vae.decoder, hidden, mesh), "mesh"
    if streamed or (streamed is None and num_bands is None and choose_branch(
            vae.dtype, B, H, W, vsf) == "streamed"):
        return _stage_b_streamed(vae.decoder, hidden), "streamed"
    n, win = _bands(H, num_bands or 1, halo)
    if n == 1:
        return vae.decode_stage_b(hidden), "monolithic"
    hs = H // n
    bands = []
    for i in range(n):
        start = min(max(i * hs - halo, 0), H - win)
        img = vae.decode_stage_b(hidden[:, :, start:start + win])
        keep = (i * hs - start) * vsf
        bands.append(img[:, :, keep:keep + hs * vsf])
    return torch.cat(bands, dim=2), "bands"
