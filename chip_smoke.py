#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py                     # every phase, every path
    python3 chip_smoke.py --phases kernels    # build + kernel checks only
    python3 chip_smoke.py --paths sd15 --log smoke.jsonl   # one path; the
                                              # JSON lines also go to a file
    python3 chip_smoke.py --phases device,build,kernels --cases 'conv3x3/sd15'
                                              # only the kernel cases whose
                                              # name matches a regex

Phases, each printing one JSON line; any failure exits non-zero:

  device    the card (nvidia-smi name and power limit), torch and CUDA
  build     nvcc builds every kernel from the sources in this checkout
  kernels   every kernel against its plain PyTorch version at every shape
            the main paths give it (the norms with the weight dtype and eps
            of the modules that launch them), with times from CUDA events and
            replayed from a CUDA graph (`device_ms`, the kernel without the
            host that launches it), with the plan each shape ran (body, tile,
            splits; for GroupNorm the clusters the card holds), and the
            GroupNorm bodies and chunk widths no path reaches (`edge`)
  model     per bundle, one full-width batch-8 UNet forward and one VAE
            decode with the kernels against the same modules with the plain
            versions; for the bundles that run the conv kernel, the forward
            with conv_impl='kernel' against conv_impl='cudnn'
  requests  ElasticDiffusion.generate_image answers requests at full width
            with seeded random weights on three paths, one bundle at a time:
            SDXL 1.0 and SD 1.5 with conv_impl='kernel', SD 2.1 with the
            default conv_impl='cudnn'; launch counts are set to 0 just before
            each path and read just after; `unchecked_launches` lists the
            shapes a path launched that the kernels phase did not check, and
            any shape among them fails the run. Then the path's first request
            runs again with every plain version and cuDNN convs, same seed:
            its final latents are held to the kernels' (`end_to_end`, rel L2
            within E2E_TOL_REL_L2), and the random draws of the two runs must
            be the same

Every bundle's biases and norm weights are moved off their seeded init
(`perturb_bundle`) as soon as it loads, so that a bias or norm parameter
wired to the wrong place shows in the model and end-to-end checks.

The last line is {"ok": true, "device": {...}}; the line before it lists
every kernel with its launches on the main paths, error, time and bound. A
run cut to some phases or paths ends in {"ok": false, "partial": ...}.
Needs a CUDA device and exits non-zero without one.
"""

from __future__ import annotations

import argparse
import collections
import gc
import json
import statistics
import subprocess
import sys
import time

import torch

# published peaks of one H100 SXM (dense): the yardstick of bound_ms
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.float32: 67e12}

ALL_PHASES = ("device", "build", "kernels", "model", "requests")


LOG_PATH = None  # --log: every emitted line is also appended to this file


def emit(obj) -> None:
    line = json.dumps(obj)
    print(line, flush=True)
    if LOG_PATH:
        with open(LOG_PATH, "a") as f:
            f.write(line + "\n")


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def time_ms(fn, warmup: int = 3, iters: int = 15) -> float:
    """Median milliseconds of one call, from CUDA events after a warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def graph_ms(fn, launches: int, iters: int = 5) -> float:
    """Median milliseconds of one call when `launches` calls are replayed from
    a CUDA graph: the device's time with no host in the way. Beside
    `time_ms` it says how much of a short call is the kernel."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / launches)
    del graph
    return statistics.median(times)


def enqueue_ms(fn, iters: int = 5) -> float:
    """Median milliseconds the host takes to enqueue one call (the device is
    idle at the start and is not waited for): where this is close to
    `time_ms`, the call is bound by the host, not by its kernels."""
    times = []
    for _ in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return statistics.median(times)


def compare(out: torch.Tensor, ref: torch.Tensor):
    """(max_abs, rel_l2, tol_abs, tol_rel, why) of a kernel's output against
    its plain version's, both in the working dtype."""
    o, r = out.float(), ref.float()
    if not torch.isfinite(o).all():
        fail("kernel output is not finite")
    max_abs = (o - r).abs().max().item()
    rel_l2 = ((o - r).norm() / r.norm().clamp_min(1e-30)).item()
    top = r.abs().max().item()
    if out.dtype == torch.bfloat16:
        # both sides round fp32 results to bf16 (8 bits of mantissa): they may
        # land one ulp apart at the largest magnitude; sums differ in order
        tol_abs, tol_rel = 2.0 ** -6 * max(top, 1e-3), 2.0 ** -7
        why = "one bf16 ulp at the largest magnitude; rel L2 of half an ulp"
    else:
        # fp32 sums in another order, exp2 against exp
        tol_abs, tol_rel = 2e-5 * max(top, 1.0), 2e-5
        why = "fp32 sum order and exp2 against exp"
    return max_abs, rel_l2, tol_abs, tol_rel, why


def bound(nbytes: float, ops: float, dtype) -> tuple:
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# kernel cases
# ---------------------------------------------------------------------------

def attention_cases():
    bf, f32 = torch.bfloat16, torch.float32
    cases = []
    # SD 2.1 (5/10/20 heads), SDXL (10/20 heads) at D=64; SD 1.5: 8 heads.
    # Batch 8 is the model check and the resampled direction forwards; the
    # requests also give 2 (cond/uncond direction forwards) and 3 and 9 (the
    # view batches of a 2:3 and a square image).
    for S, H, D in ((4096, 5, 64), (1024, 10, 64), (256, 20, 64),
                    (4096, 10, 64), (1024, 20, 64),
                    (4096, 8, 40), (1024, 8, 80), (256, 8, 160)):
        for B in (8, 2, 3, 9):
            cases.append(("self", bf, B, S, S, H, D))
            cases.append(("cross", bf, B, S, 77, H, D))
    cases.append(("vae_mid", bf, 1, 6144, 6144, 1, 512))
    cases.append(("vae_mid", bf, 1, 9216, 9216, 1, 512))
    cases.append(("vae_mid", f32, 1, 4096, 4096, 1, 512))
    cases.append(("vae_strip", f32, 1, 704, 704, 1, 512))
    # SDXL decodes in fp32 (force_upcast): 1024x1536 px is 128x192 tokens,
    # 1536x1536 px 192x192; its background strips encode at 21 and 22 rows
    cases.append(("vae_mid", f32, 1, 24576, 24576, 1, 512))
    cases.append(("vae_mid", f32, 1, 36864, 36864, 1, 512))
    cases.append(("vae_strip", f32, 1, 2688, 2688, 1, 512))
    cases.append(("vae_strip", f32, 1, 2816, 2816, 1, 512))
    for D in (40, 80, 160):  # the fp32 instantiations, on no path today
        cases.append(("self", f32, 2, 1024, 1024, 8, D))
    # edges of the wgmma body, on no path: query rows and keys that fill no
    # tile, one key, one key more than the single tile holds, a ring that
    # wraps with a ragged tail, and q, k, v as chunks of one fused projection
    cases.append(("ragged", bf, 2, 300, 200, 3, 64))
    cases.append(("ragged", bf, 2, 300, 81, 3, 40))
    cases.append(("ragged", bf, 1, 1000, 1, 2, 80))
    cases.append(("ragged", bf, 3, 333, 80, 2, 160))
    cases.append(("ragged", bf, 1, 2000, 1001, 12, 64))
    cases.append(("fused_qkv", bf, 2, 1024, 1024, 10, 64))
    cases.append(("fused_qkv", bf, 2, 1024, 1024, 8, 80))
    # edges of the bf16 body at head dim 512, on no path: ragged rows and
    # keys over two strided heads (split keys), one ragged key tile, and
    # 132 row blocks (one split: the block stores bf16 itself)
    cases.append(("ragged", bf, 2, 1000, 777, 2, 512))
    cases.append(("ragged", bf, 1, 50, 20, 1, 512))
    cases.append(("one_split", bf, 1, 8448, 8448, 1, 512))
    return cases


def run_attention(gen, results):
    import torch.nn.functional as F
    from elasticdiffusion_tpu_torch.kernels.flash_attention import (
        attention_plan, flash_attention, reference_attention)
    for tag, dtype, B, Sq, Sk, H, D in attention_cases():
        if not wanted(f"flash_attention/{tag}_{str(dtype)[6:]}_{B}x{Sq}x{H}x{D}_Sk{Sk}"):
            continue
        # q/k/v as the strided head views of (B, S, H*D) projections, or of
        # the three chunks of one (B, S, 3*H*D) projection
        if tag == "fused_qkv":
            q, k, v = (t.view(B, Sq, H, D) for t in torch.randn(
                B, Sq, 3 * H * D, generator=gen, device="cuda").to(
                    dtype).chunk(3, dim=-1))
        else:
            q, k, v = (torch.randn(B, S, H * D, generator=gen, device="cuda",
                                   dtype=torch.float32).to(dtype).view(B, S, H, D)
                       for S in (Sq, Sk, Sk))
        out = flash_attention(q, k, v)
        torch.cuda.synchronize()
        ref = reference_attention(q, k, v)
        max_abs, rel_l2, tol_abs, tol_rel, why = compare(out, ref)
        isz = q.element_size()
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * isz
        ops = 4.0 * B * H * Sq * Sk * D
        b_ms, b_by = bound(nbytes, ops, dtype)
        reps = (1, 5) if b_ms > 5.0 else (3, 15)  # the long fp32 decodes
        ms = time_ms(lambda: flash_attention(q, k, v), *reps)
        plain_ms = time_ms(lambda: reference_attention(q, k, v), 1, 5)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt),
                         *reps)
        # short calls again without the host: about 2 ms of launches a replay
        n = max(1, min(20, int(2.0 / ms)))
        device_ms = graph_ms(lambda: flash_attention(q, k, v), n)
        lib_device_ms = graph_ms(
            lambda: F.scaled_dot_product_attention(qt, kt, vt), n)
        plan = attention_plan(dtype, B, Sq, Sk, H, D)
        results.append({
            "name": f"flash_attention/{tag}_{str(dtype)[6:]}_{B}x{Sq}x{H}x{D}_Sk{Sk}",
            "kernel": "flash_attention", "route": "cuda",
            "source": "elasticdiffusion_tpu_torch/kernels/csrc/flash_attention.cu",
            "replaces": "elasticdiffusion_tpu/kernels/flash_attention.py:"
                        + ("355" if D == 512 else "228"),
            "log_key": ("flash_attention", str(dtype), B, Sq, Sk, H, D),
            "body": plan.body, "splits": plan.splits,
            "max_abs_err": max_abs, "rel_l2_err": rel_l2,
            "tol_abs": tol_abs, "tol_rel": tol_rel, "tol_why": why,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": lib_ms,
            "device_ms": device_ms, "library_device_ms": lib_device_ms,
            "library": "F.scaled_dot_product_attention"})
        del q, k, v, out, ref
        torch.cuda.empty_cache()


def attention_host_us(gen):
    """Host microseconds the attention wrapper takes to enqueue one launch
    (tensor maps encoded on the host at every launch of the wgmma bodies),
    at head dims 64 and 512 at a small shape."""
    from elasticdiffusion_tpu_torch.kernels.flash_attention import flash_attention
    out = {}
    for body, H, D in (("wgmma", 20, 64), ("wgmma.d512", 1, 512)):
        q = torch.randn(2, 256, H * D, generator=gen, device="cuda").to(
            torch.bfloat16).view(2, 256, H, D)
        flash_attention(q, q, q)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(200):
            flash_attention(q, q, q)
        out[body] = (time.perf_counter() - t0) / 200 * 1e6
        torch.cuda.synchronize()
    return out


def layernorm_cases():
    """(tag, dtype, weight dtype, eps, N, C) of every LayerNorm the paths
    launch: the UNet transformer blocks (tokens x width, times the batches
    the requests give: 8, 2, 3 and 9 as for attention; SD 1.5's 512x768
    request has 3 views) and the text encoders' 77 tokens. Both keep their
    weights in the bf16 parameter dtype and use eps 1e-5 (LayerNorm32's
    default, CLIPTextConfig.layer_norm_eps). Every case is timed in full."""
    bf = torch.bfloat16
    unet = (("sdxl", ((4096, 640), (1024, 1280)), (8, 2, 3, 9)),
            ("sd15", ((4096, 320), (1024, 640), (256, 1280), (64, 1280)),
             (8, 2, 3)),
            ("sd21", ((4096, 320), (1024, 640), (256, 1280), (64, 1280)),
             (8, 2, 3, 9)))
    cases, seen = [], set()
    for tag, shapes, batches in unet:
        for S, C in shapes:
            for B in batches:
                if (B * S, C) not in seen:
                    seen.add((B * S, C))
                    cases.append((tag, bf, bf, 1e-5, B * S, C))
    for C in (768, 1280, 1024):  # CLIP L (SD 1.x, SDXL), bigG, OpenCLIP H
        cases.append(("clip", bf, bf, 1e-5, 77, C))
    return cases


def run_layernorm(gen, results):
    import torch.nn.functional as F
    from elasticdiffusion_tpu_torch.kernels.layernorm import (
        fused_layer_norm, layernorm_plan, reference_layer_norm)
    for tag, dtype, w_dtype, eps, N, C in layernorm_cases():
        name = f"fused_layer_norm/{tag}_{str(dtype)[6:]}_{N}x{C}"
        if not wanted(name):
            continue
        x = (torch.randn(N, C, generator=gen, device="cuda") * 1.5 + 0.3).to(dtype)
        w = (1 + 0.1 * torch.randn(C, generator=gen, device="cuda")).to(w_dtype)
        b = (0.1 * torch.randn(C, generator=gen, device="cuda")).to(w_dtype)
        out = fused_layer_norm(x, w, b, eps)
        torch.cuda.synchronize()
        ref = reference_layer_norm(x, w, b, eps)
        max_abs, rel_l2, tol_abs, tol_rel, why = compare(out, ref)
        kernel = lambda: fused_layer_norm(x, w, b, eps)
        lw, lb = w.to(dtype), b.to(dtype)  # the library takes x's dtype
        lib = lambda: F.layer_norm(x, (C,), lw, lb, eps)
        nbytes = 2 * x.numel() * x.element_size() + 2 * C * w.element_size()
        b_ms, b_by = bound(nbytes, 8.0 * N * C, torch.float32)
        results.append({
            "name": name, "kernel": "fused_layer_norm", "route": "cuda",
            "source": "elasticdiffusion_tpu_torch/kernels/csrc/layernorm.cu",
            "replaces": "elasticdiffusion_tpu/kernels/layernorm.py:66",
            "log_key": ("fused_layer_norm", str(dtype), str(w_dtype), eps, N, C),
            "weight_dtype": str(w_dtype), "eps": eps,
            "body": layernorm_plan(C, dtype).body,
            "max_abs_err": max_abs, "rel_l2_err": rel_l2,
            "tol_abs": tol_abs, "tol_rel": tol_rel, "tol_why": why,
            "bound_ms": b_ms, "bound_by": b_by, "library": "F.layer_norm",
            **norm_times(kernel, lambda: reference_layer_norm(x, w, b, eps),
                         lib, True)})


def norm_times(kernel, plain, lib, full: bool) -> dict:
    """Times of one norm case. Every case: event ms of the kernel, the
    plain version and the library call, and the kernel's device time
    replayed from a CUDA graph; `full` cases take more samples and the
    library's device time too."""
    reps = (3, 15) if full else (1, 3)
    out = {"ms": time_ms(kernel, *reps),
           "plain_ms": time_ms(plain, 1, 5 if full else 1),
           "library_ms": time_ms(lib, *reps)}
    # about 2 ms of launches a replay
    n = max(1, min(20, int(2.0 / out["ms"])))
    out["device_ms"] = graph_ms(kernel, n, 5 if full else 3)
    out["library_device_ms"] = graph_ms(lib, n) if full else None
    return out


def groupnorm_cases():
    """(tag, dtype, weight dtype, eps, B, H, W, C, silu, full) of every
    GroupNorm the paths launch, with the weight dtype and eps of the module
    that launches it: the UNet's ResNet norms (SiLU, eps 1e-5) and
    Transformer2D norms (no SiLU, eps 1e-6), bf16 weights, at the batches
    the requests give; the VAE decoders (bf16 activations with the fp32 norm
    weights of the compute copy for SD 1.x / 2.x, fp32 for the SDXL
    force_upcast decode) and the fp32 background-strip encodes, all eps 1e-6.
    `full` (timed in full): batch 8, and every VAE shape."""
    bf, f32 = torch.bfloat16, torch.float32
    T, F_ = True, False
    sdxl = ((128, 320, T), (128, 640, T), (128, 960, T), (64, 320, T),
            (64, 640, F_), (64, 640, T), (64, 960, T), (64, 1280, T),
            (64, 1920, T), (32, 640, T), (32, 1280, F_), (32, 1280, T),
            (32, 1920, T), (32, 2560, T))
    sd = ((64, 320, F_), (64, 320, T), (64, 640, T), (64, 960, T),
          (32, 320, T), (32, 640, F_), (32, 640, T), (32, 960, T),
          (32, 1280, T), (32, 1920, T), (16, 640, T), (16, 1280, F_),
          (16, 1280, T), (16, 1920, T), (16, 2560, T), (8, 1280, F_),
          (8, 1280, T), (8, 2560, T))
    cases, seen = [], set()

    def add(tag, dtype, w_dtype, eps, B, H, W, C, silu):
        key = (dtype, w_dtype, eps, B, H, W, C, silu)
        if key not in seen:
            seen.add(key)
            cases.append((tag, dtype, w_dtype, eps, B, H, W, C, silu,
                          B == 1 or B == 8))

    for tag, shapes, batches in (("sdxl", sdxl, (8, 2, 3, 9)),
                                 ("sd15", sd, (8, 2, 3)),
                                 ("sd21", sd, (8, 2, 3, 9))):
        for S, C, silu in shapes:
            for B in batches:
                add(tag, bf, bf, 1e-5 if silu else 1e-6, B, S, S, C, silu)
    # decoders at latent (h, w): mid block (and its attention's norm), the
    # four up blocks, norm_out. SD 1.x / 2.x bf16 at 512x768 and 768x768
    # px; SDXL fp32 at 1024x1536 and 1536x1536 px
    for dtype, latents in ((bf, ((64, 96), (96, 96))),
                           (f32, ((128, 192), (192, 192)))):
        for h, w in latents:
            for k, C, silu in ((1, 512, F_), (1, 512, T), (2, 512, T),
                               (4, 512, T), (4, 256, T), (8, 256, T),
                               (8, 128, T)):
                add("vae_decode", dtype, f32, 1e-6, 1, k * h, k * w, C, silu)
    # fp32 encoders of the background strips (image rows x width): SD 1.x /
    # 2.x 88x512, SDXL 168x1024 and 176x1024
    for H, W in ((88, 512), (168, 1024), (176, 1024)):
        for k, C, silu in ((1, 128, T), (2, 128, T), (2, 256, T), (4, 256, T),
                           (4, 512, T), (8, 512, F_), (8, 512, T)):
            add("vae_encode", f32, f32, 1e-6, 1, H // k, W // k, C, silu)
    return cases


def groupnorm_edge_cases():
    """(tag, dtype, weight dtype, eps, B, H, W, C, groups, silu, offset) of
    the bodies and spans no path shape reaches: a cluster over 144-byte
    spans (whole 16-byte chunks, not whole sectors), two passes over rows of
    1024 16-byte chunks, over 60-byte rows and over an input one element
    off 16-byte alignment (`offset`). Timed briefly."""
    bf, f32 = torch.bfloat16, torch.float32
    return [("edge", bf, f32, 1e-6, 2, 12, 20, 72, 8, True, 0),
            ("edge", bf, bf, 1e-5, 1, 96, 96, 8192, 32, True, 0),
            ("edge", bf, f32, 1e-6, 2, 24, 24, 30, 1, True, 0),
            ("edge", bf, bf, 1e-5, 2, 64, 64, 320, 32, True, 1)]


def plan_fields(plan) -> dict:
    return {k: v for k, v in plan._asdict().items() if k not in ("body", "code")}


def run_groupnorm(gen, results):
    import torch.nn.functional as F
    from elasticdiffusion_tpu_torch.kernels.groupnorm import (
        _align, fused_group_norm, groupnorm_plan, max_active_clusters,
        reference_group_norm)
    clusters = {}  # (dtype, cluster, smem) -> clusters the card holds
    cases = [c[:8] + (32,) + c[8:9] + (0, c[9]) for c in groupnorm_cases()]
    cases += [c + (False,) for c in groupnorm_edge_cases()]
    for tag, dtype, w_dtype, eps, B, H, W, C, G, silu, offset, full in cases:
        name = (f"fused_group_norm/{tag}_{str(dtype)[6:]}_{B}x{H}x{W}x{C}"
                + (f"_g{G}" if G != 32 else "") + ("_silu" if silu else "")
                + (f"_off{offset}" if offset else ""))
        if not wanted(name):
            continue
        x = torch.empty(B * H * W * C + offset, device="cuda", dtype=dtype)[
            offset:].view(B, H, W, C)
        x.copy_(torch.randn(B, H, W, C, generator=gen, device="cuda") * 1.5
                + 0.3)
        w = (1 + 0.1 * torch.randn(C, generator=gen, device="cuda")).to(w_dtype)
        b = (0.1 * torch.randn(C, generator=gen, device="cuda")).to(w_dtype)
        x_nchw = x.permute(0, 3, 1, 2)  # channels_last view for the library
        plan = groupnorm_plan(dtype, B, H * W, C, G, w_dtype,
                              _align(x.data_ptr()))
        extra = {}
        if plan.body == "cluster":
            key = (dtype, plan.cluster, plan.smem_bytes)
            if key not in clusters:
                clusters[key] = max_active_clusters(plan, dtype)
            extra["max_active_clusters"] = clusters[key]
            if clusters[key] < 1:
                fail(f"{name}: the card cannot hold one cluster of {plan}")
        try:
            out = fused_group_norm(x, w, b, G, eps, silu)
            torch.cuda.synchronize()
        except RuntimeError as e:
            fail(f"{name} ({plan}): {e}")
        ref = reference_group_norm(x, w, b, G, eps, silu)
        max_abs, rel_l2, tol_abs, tol_rel, why = compare(out, ref)
        del out, ref
        lw, lb = w.to(dtype), b.to(dtype)  # the library takes x's dtype
        if silu:
            lib = lambda: F.silu(F.group_norm(x_nchw, G, lw, lb, eps))
        else:
            lib = lambda: F.group_norm(x_nchw, G, lw, lb, eps)
        nbytes = 2 * x.numel() * x.element_size() + 2 * C * w.element_size()
        b_ms, b_by = bound(nbytes, 8.0 * x.numel(), torch.float32)
        results.append({
            "name": name, "kernel": "fused_group_norm", "route": "cuda",
            "source": "elasticdiffusion_tpu_torch/kernels/csrc/groupnorm.cu",
            "replaces": "elasticdiffusion_tpu/kernels/groupnorm.py:94",
            "log_key": ("fused_group_norm", str(dtype), str(w_dtype), eps,
                        B, H, W, C, silu),
            "weight_dtype": str(w_dtype), "eps": eps,
            "body": plan.body, "plan": {**plan_fields(plan), **extra},
            "max_abs_err": max_abs, "rel_l2_err": rel_l2,
            "tol_abs": tol_abs, "tol_rel": tol_rel, "tol_why": why,
            "bound_ms": b_ms, "bound_by": b_by,
            "library": "F.group_norm" + (" + F.silu" if silu else ""),
            **norm_times(
                lambda: fused_group_norm(x, w, b, G, eps, silu),
                lambda: reference_group_norm(x, w, b, G, eps, silu),
                lib, full)})
        del x, x_nchw
        if nbytes > (256 << 20):  # the large fp32 decoder shapes
            torch.cuda.empty_cache()


def conv_cases():
    """(tag, dtype, B, H, W, C, O, silu, bias dtype or None)."""
    bf, f32 = torch.bfloat16, torch.float32
    cases = []
    sdxl = ((128, 320, 320), (128, 960, 320), (128, 640, 320),
            (64, 320, 640), (64, 640, 640), (64, 1920, 640), (64, 1280, 640),
            (64, 960, 640), (32, 640, 1280), (32, 1280, 1280),
            (32, 2560, 1280), (32, 1920, 1280),
            (64, 1280, 1280), (128, 640, 640))   # the two upsample convs
    sd15 = ((64, 320, 320), (32, 640, 640), (16, 1280, 1280), (8, 1280, 1280),
            (16, 2560, 1280), (8, 2560, 1280), (16, 640, 1280),
            (16, 1920, 1280), (32, 320, 640), (32, 1920, 640),
            (32, 1280, 640), (32, 960, 640), (64, 960, 320), (64, 640, 320))
    # the batches the requests give the UNet: 8 (resampled direction
    # forwards and the model check), 2 (cond/uncond direction forwards), 3
    # and 9 (the view batches of a 2:3 and a square SDXL image; SD 1.5's
    # 512x768 request has 3 views)
    for tag, shapes, batches in (("sdxl", sdxl, (8, 2, 3, 9)),
                                 ("sd15", sd15, (8, 2, 3))):
        for S, C, O in shapes:
            for B in batches:
                cases.append((tag, bf, B, S, S, C, O, False, bf))
    cases.append(("ragged", bf, 8, 96, 96, 320, 320, False, f32))
    cases.append(("ragged", bf, 2, 42, 61, 328, 72, False, None))
    cases.append(("ragged", bf, 3, 5, 7, 200, 136, True, bf))
    cases.append(("small_c", bf, 2, 24, 40, 48, 64, False, bf))  # C < 64
    cases.append(("silu", bf, 8, 64, 64, 640, 640, True, bf))
    cases.append(("fp32", f32, 2, 64, 64, 320, 320, False, f32))
    cases.append(("fp32_ragged", f32, 1, 21, 37, 136, 72, True, f32))
    return cases


def run_conv3x3(gen, results):
    import torch.nn.functional as F
    from elasticdiffusion_tpu_torch.kernels.conv3x3 import (
        conv3x3, conv_plan, reference_conv3x3)
    cl = torch.channels_last
    for tag, dtype, B, H, W, C, O, silu, bias_dtype in conv_cases():
        name = (f"conv3x3/{tag}_{str(dtype)[6:]}_{B}x{H}x{W}x{C}->{O}"
                + ("_silu" if silu else ""))
        if not wanted(name):
            continue
        # the operands as the module hands them over: the NHWC view of a
        # channels_last activation, the HWIO view of a channels_last weight
        x_nchw = torch.randn(B, C, H, W, generator=gen, device="cuda").to(
            dtype).contiguous(memory_format=cl)
        w_oihw = (torch.randn(O, C, 3, 3, generator=gen, device="cuda")
                  / (9 * C) ** 0.5).to(dtype).contiguous(memory_format=cl)
        bias = None if bias_dtype is None else (0.1 * torch.randn(
            O, generator=gen, device="cuda")).to(bias_dtype)
        x, w = x_nchw.permute(0, 2, 3, 1), w_oihw.permute(2, 3, 1, 0)
        copies = conv3x3.copies
        out = conv3x3(x, w, bias, silu)
        torch.cuda.synchronize()
        if conv3x3.copies != copies:
            fail(f"conv3x3/{tag}: a channels_last operand was copied")
        ref = reference_conv3x3(x, w, bias, silu)
        max_abs, rel_l2, tol_abs, tol_rel, why = compare(out, ref)
        kernel = lambda: conv3x3(x, w, bias, silu)
        ms = time_ms(kernel)
        plain_ms = time_ms(lambda: reference_conv3x3(x, w, bias, silu), 1, 3)
        lib_bias = None if bias is None else bias.to(dtype)
        if silu:
            lib = lambda: F.silu(F.conv2d(x_nchw, w_oihw, lib_bias, padding=1))
        else:
            lib = lambda: F.conv2d(x_nchw, w_oihw, lib_bias, padding=1)
        lib_ms = time_ms(lib)
        # again without the host: about 2 ms of launches a replay
        n = max(1, min(20, int(2.0 / ms)))
        device_ms = graph_ms(kernel, n)
        lib_device_ms = graph_ms(lib, n)
        plan = conv_plan(dtype, B, H, W, C, O)
        nbytes = (x.numel() + w.numel() + out.numel()) * x.element_size() \
            + (0 if bias is None else bias.numel() * bias.element_size())
        ops = 2.0 * 9 * C * O * B * H * W
        b_ms, b_by = bound(nbytes, ops, dtype)
        results.append({
            "name": name, "kernel": "conv3x3", "route": "cuda",
            "source": "elasticdiffusion_tpu_torch/kernels/csrc/conv3x3.cu",
            "replaces": "elasticdiffusion_tpu/kernels/conv3x3.py:166",
            "log_key": ("conv3x3", str(dtype), B, H, W, C, O, silu),
            "max_abs_err": max_abs, "rel_l2_err": rel_l2,
            "tol_abs": tol_abs, "tol_rel": tol_rel,
            "tol_why": why + "; both sides sum the 9*C exact products in fp32",
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": lib_ms,
            "device_ms": device_ms, "library_device_ms": lib_device_ms,
            "tflops": ops / device_ms / 1e9,
            "body": plan.body, "splits": plan.splits,
            "plan": {"tile": list(plan.tile), "bn": plan.bn,
                     "stages": plan.stages, "blocks": plan.blocks},
            "library": "F.conv2d" + (" + F.silu" if silu else "")})
        del x_nchw, w_oihw, x, w, out, ref
        torch.cuda.empty_cache()


CASES = None  # --cases: a regex; only the kernel cases whose name matches


def wanted(name: str) -> bool:
    return CASES is None or CASES.search(name) is not None


def phase_kernels():
    gen = torch.Generator(device="cuda").manual_seed(0)
    results = []
    run_attention(gen, results)
    run_layernorm(gen, results)
    run_groupnorm(gen, results)
    run_conv3x3(gen, results)
    bad = [r["name"] for r in results
           if not (r["max_abs_err"] <= r["tol_abs"]
                   and r["rel_l2_err"] <= r["tol_rel"])]
    emit({"phase": "kernels",
          "attention_host_us_per_launch": attention_host_us(gen),
          "allow_tf32": {"matmul": torch.backends.cuda.matmul.allow_tf32,
                         "cudnn": torch.backends.cudnn.allow_tf32},
          "cases": [{k: v for k, v in r.items() if k != "log_key"}
                    for r in results]})
    if bad:
        fail(f"kernels disagree with their plain versions: {bad}")
    return results


# ---------------------------------------------------------------------------
# model and requests
# ---------------------------------------------------------------------------

def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.float(), b.float()
    return ((a - b).norm() / b.norm().clamp_min(1e-30)).item()


# the three paths of the requests phase: bundle, conv_impl, latent of the
# batch-8 model check, requests
PATHS = (
    {"name": "sdxl", "sd_version": "XL1.0", "conv_impl": "kernel",
     "latent": 128,
     "requests": ({"height": 1024, "width": 1536},
                  {"height": 1536, "width": 1536})},
    {"name": "sd15", "sd_version": "1.5", "conv_impl": "kernel", "latent": 64,
     "requests": ({"height": 512, "width": 768},)},
    {"name": "sd21", "sd_version": "2.1", "conv_impl": "cudnn", "latent": 64,
     "requests": ({"height": 512, "width": 768},
                  {"height": 768, "width": 768})},
)


def phase_model(bundle, path):
    """Kernels against plain versions inside the full-width models, and for
    a path that runs it, the conv kernel against cuDNN."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    dt = bundle.runtime.compute_dtype
    ucfg = bundle.config.unet
    n = path["latent"]
    lat = torch.randn(8, 4, n, n, generator=gen, device="cuda").to(dt)
    ctx = torch.randn(8, 77, ucfg.cross_attention_dim, generator=gen,
                      device="cuda").to(dt)
    kw = {}
    if bundle.config.is_xl:
        kw = {"added_text_embeds": torch.randn(
                  8, ucfg.pooled_projection_dim, generator=gen, device="cuda"),
              "added_time_ids": torch.tensor(
                  [[4096.0, 6144.0, 0.0, 0.0, 4096.0, 6144.0]],
                  device="cuda").expand(8, 6)}
    z = torch.randn(1, 4, 64, 96, generator=gen, device="cuda")
    out = {"phase": "model", "path": path["name"], "tolerance_rel_l2": 5e-2,
           "tolerance_why": "bf16 activations through the whole network; the "
                            "kernel and plain norms, and the conv kernel and "
                            "cuDNN, round and sum at different places"}
    unet = lambda: bundle.apply_unet(lat, 501.0, ctx, **kw)
    res = {}
    bundle.set_conv_impl("cudnn")
    for mode in ("auto", "off"):
        bundle.set_use_kernels(mode)
        res[mode] = (unet(), bundle.vae_decode(z))
        # steady state, after the first call's cuDNN and cuBLAS set-up
        out[f"unet_ms_{mode}"] = time_ms(unet, 1, 5)
        out[f"unet_enqueue_ms_{mode}"] = enqueue_ms(unet)
        out[f"decode_ms_{mode}"] = time_ms(lambda: bundle.vae_decode(z), 1, 5)
    bundle.set_use_kernels("auto")
    checks = [("unet", res["auto"][0], res["off"][0]),
              ("vae_decode", res["auto"][1], res["off"][1])]
    if path["conv_impl"] == "kernel":
        bundle.set_conv_impl("kernel")
        res["conv"] = unet()
        # the two in turns inside one run: kernel, cudnn, cudnn, kernel
        t_k1 = time_ms(unet, 1, 5)
        bundle.set_conv_impl("cudnn")
        t_c = time_ms(unet, 1, 10)
        bundle.set_conv_impl("kernel")
        t_k2 = time_ms(unet, 1, 5)
        out["unet_ms_conv_kernel"] = [t_k1, t_k2]
        out["unet_ms_conv_cudnn"] = t_c
        checks.append(("unet_conv_kernel", res["conv"], res["auto"][0]))
    bundle.set_conv_impl(path["conv_impl"])
    for name, a, b in checks:
        if not torch.isfinite(a.float()).all():
            fail(f"{path['name']} {name}: output with kernels is not finite")
        out[f"{name}_shape"] = list(a.shape)
        out[f"{name}_rel_l2"] = rel_l2(a, b)
    emit(out)
    for name, _, _ in checks:
        if not out[f"{name}_rel_l2"] <= out["tolerance_rel_l2"]:
            fail(f"{path['name']} {name}: rel L2 {out[f'{name}_rel_l2']} over "
                 f"{out['tolerance_rel_l2']}")


def kernel_counts():
    from elasticdiffusion_tpu_torch.kernels.conv3x3 import conv3x3
    from elasticdiffusion_tpu_torch.kernels.flash_attention import flash_attention
    from elasticdiffusion_tpu_torch.kernels.groupnorm import fused_group_norm
    from elasticdiffusion_tpu_torch.kernels.layernorm import fused_layer_norm
    return {"flash_attention": flash_attention, "fused_layer_norm": fused_layer_norm,
            "fused_group_norm": fused_group_norm, "conv3x3": conv3x3}


def plain_cuda_counts():
    from elasticdiffusion_tpu_torch.kernels.attention import dot_product_attention
    from elasticdiffusion_tpu_torch.kernels.groupnorm import group_norm
    from elasticdiffusion_tpu_torch.kernels.layernorm import layer_norm
    return {"attention": dot_product_attention, "layer_norm": layer_norm,
            "group_norm": group_norm}


def gate_convs(unet):
    """The UNet's Conv3x3 modules whose widths are inside the kernel's gate."""
    from elasticdiffusion_tpu_torch.kernels.conv3x3 import in_gate
    from elasticdiffusion_tpu_torch.models.layers import Conv3x3
    return [m for m in unet.modules() if isinstance(m, Conv3x3)
            and in_gate((1, 8, 8, m.in_channels),
                        (3, 3, m.in_channels, m.out_channels))]


@torch.no_grad()
def perturb_bundle(bundle, seed: int) -> int:
    """Moves every bias and every norm weight of a freshly loaded bundle off
    its seeded init (biases 0, norm weights 1) by 0.1 N(0, 1) from a seeded
    generator, so that a bias or a norm parameter wired to the wrong place
    changes the answer. The compute-dtype VAE copy takes the fp32 VAE's new
    values. Returns the number of tensors moved."""
    import torch.nn as nn
    gen = torch.Generator(device=bundle.device).manual_seed(seed)
    moved = 0
    for model in (bundle.unet, bundle.vae_fp32, *bundle.text_models):
        for m in model.modules():
            params = [m.bias] if isinstance(getattr(m, "bias", None),
                                            nn.Parameter) else []
            if (isinstance(getattr(m, "weight", None), nn.Parameter)
                    and params and not isinstance(
                        m, (nn.Linear, nn.Conv2d, nn.Embedding))):
                params.append(m.weight)  # a norm (seeded_init_'s rule)
            for p in params:
                p.add_((0.1 * torch.randn(p.shape, generator=gen,
                                          device=p.device)).to(p.dtype))
                moved += 1
    if bundle.vae is not bundle.vae_fp32:
        for a, b in zip(bundle.vae.parameters(), bundle.vae_fp32.parameters()):
            a.copy_(b)
    return moved


class record_generators:
    """Records every torch.Generator made while the block runs. Their states
    after a request say whether two runs drew the same random numbers: the
    same seeds and the same states after the run mean the same draws."""

    def __enter__(self):
        self.made, self.orig = [], torch.Generator

        def make(*a, **k):
            g = self.orig(*a, **k)
            self.made.append(g)
            return g

        torch.Generator = make
        return self

    def __exit__(self, *exc):
        torch.Generator = self.orig

    def states(self):
        return [g.get_state() for g in self.made]


# End to end on the card: the final latents of a path's smallest request with
# the kernels (the path's conv_impl) against the same request with every
# plain version and cuDNN convs, same seed, perturbed norms and biases.
E2E_TOL_REL_L2 = 5e-2
E2E_TOL_WHY = ("bf16 activations through 4 steps of 2(rs+1)+V UNet forwards: "
               "the kernels and the plain versions round and sum at different "
               "places in every norm, attention and conv; the first runs on "
               "an H100 measured 0.026-0.035 on the three paths, and one "
               "batch-8 forward differs by 0.016-0.018 (the model phase's "
               "bar is 5e-2 too)")


def generate(pipe, path, req, steps: int, resampling: int, seed: int):
    """One request of a path from a seed; (images, info, generator states)."""
    pipe.seed_everything(seed)
    with record_generators() as rec:
        imgs, info = pipe.generate_image(
            "a photo of a lighthouse on a cliff at dusk", negative_prompts="",
            num_inference_steps=steps, resampling_steps=resampling,
            repaint_sampling=True, return_arrays=True, **req)
    torch.cuda.synchronize()
    return imgs, info, rec.states()


def end_to_end(pipe, path, steps: int, resampling: int, kernel_run) -> dict:
    """The path's smallest request again with every kernel off, against
    `kernel_run` = (info, generator states) of the same request and seed
    with the kernels."""
    bundle = pipe.bundle
    bundle.set_use_kernels("off")
    bundle.set_conv_impl("cudnn")
    try:
        _, info, states = generate(pipe, path, path["requests"][0], steps,
                                   resampling, 0)
    finally:
        bundle.set_use_kernels("auto")
        bundle.set_conv_impl(path["conv_impl"])
    k_info, k_states = kernel_run
    same_draws = len(states) == len(k_states) and all(
        torch.equal(a, b) for a, b in zip(states, k_states))
    a = torch.as_tensor(k_info["latent"]).float()
    b = torch.as_tensor(info["latent"]).float()
    return {"request": path["requests"][0], "latent_shape": list(a.shape),
            "rel_l2": rel_l2(a, b), "max_abs": (a - b).abs().max().item(),
            "finite": bool(torch.isfinite(a).all() and torch.isfinite(b).all()),
            "tolerance_rel_l2": E2E_TOL_REL_L2, "tolerance_why": E2E_TOL_WHY,
            "generators": len(states), "same_random_draws": same_draws}


def phase_requests(pipe, path, steps: int, resampling: int, checked=None):
    """One main path. Every launch count is set to 0 just before and read
    just after; comparison launches of the other phases do not count.
    `checked` is the set of launch-log keys the kernels phase held against a
    plain version (None when that phase did not run): a shape launched here
    and checked nowhere fails the run. After the counts are read, the first
    request runs again with the plain versions (`end_to_end`)."""
    import elasticdiffusion_tpu_torch.kernels as kernels
    wrappers, plain = kernel_counts(), plain_cuda_counts()
    conv_on = path["conv_impl"] == "kernel"
    convs = gate_convs(pipe.bundle.unet)
    for w in wrappers.values():
        w.launches = 0
    wrappers["conv3x3"].copies = 0
    wrappers["fused_group_norm"].copies = 0
    for d in plain.values():
        d.plain_cuda_calls = 0
    for m in convs:
        m.library_cuda_calls = 0
    unet_calls = [0]
    hook = pipe.bundle.unet.register_forward_hook(
        lambda *a: unet_calls.__setitem__(0, unet_calls[0] + 1))
    kernels.launch_log = collections.Counter()

    answers, first = [], None
    for i, req in enumerate(path["requests"]):
        before = {n: w.launches for n, w in wrappers.items()}
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        imgs, info, states = generate(pipe, path, req, steps, resampling, i)
        wall = time.time() - t0
        if i == 0:
            first = (info, states)
        launched = {n: w.launches - before[n] for n, w in wrappers.items()}
        ok_shape = tuple(imgs.shape) == (1, 3, req["height"], req["width"])
        finite = bool(torch.isfinite(torch.as_tensor(imgs)).all())
        lo, hi = float(imgs.min()), float(imgs.max())
        answers.append({"request": req, "image_shape": list(imgs.shape),
                        "finite": finite, "min": lo, "max": hi,
                        "std": float(imgs.std()), "launches": launched,
                        "wall_seconds": wall,
                        "max_memory_allocated": torch.cuda.max_memory_allocated(),
                        "last_metrics": pipe.last_metrics})
        if not ok_shape:
            fail(f"{path['name']} {req}: image shape {tuple(imgs.shape)}")
        if not finite or lo < 0.0 or hi > 1.0:
            fail(f"{path['name']} {req}: image not finite or outside [0, 1]")
        if not hi > lo:
            fail(f"{path['name']} {req}: image is constant")
        never = [n for n, c in launched.items()
                 if c == 0 and (conv_on or n != "conv3x3")]
        if never:
            fail(f"{path['name']} {req}: never launched: {never}")
    hook.remove()
    log = kernels.launch_log
    kernels.launch_log = None
    plain_calls = {n: d.plain_cuda_calls for n, d in plain.items()}
    totals = {n: w.launches for n, w in wrappers.items()}
    cudnn_in_gate = sum(m.library_cuda_calls for m in convs)
    gn_copies = wrappers["fused_group_norm"].copies
    e2e = end_to_end(pipe, path, steps, resampling, first)
    expected_conv = len(convs) * unet_calls[0] if conv_on else 0
    unchecked = {} if checked is None else {
        "/".join(map(str, key)): n for key, n in sorted(log.items(), key=str)
        if key not in checked}
    emit({"phase": "requests", "path": path["name"],
          "sd_version": path["sd_version"], "conv_impl": path["conv_impl"],
          "steps": steps, "resampling_steps": resampling,
          "answers": answers, "plain_versions_on_cuda": plain_calls,
          "launches": totals, "unet_calls": unet_calls[0],
          "gate_convs_per_unet_call": len(convs),
          "conv3x3_expected_launches": expected_conv,
          "conv3x3_operand_copies": wrappers["conv3x3"].copies,
          "cudnn_calls_in_gate": cudnn_in_gate,
          "group_norm_operand_copies": gn_copies,
          "unchecked_launches": unchecked, "end_to_end": e2e})
    if unchecked:
        fail(f"{path['name']}: kernels launched at shapes that no kernel case "
             f"checks: {sorted(unchecked)}")
    if any(plain_calls.values()):
        fail(f"a plain version stood in for a kernel on the GPU: {plain_calls}")
    if not (e2e["finite"] and e2e["same_random_draws"]
            and e2e["rel_l2"] <= E2E_TOL_REL_L2):
        fail(f"{path['name']}: kernels against plain versions end to end: "
             f"{e2e}")
    if conv_on and cudnn_in_gate:
        fail(f"{path['name']}: nn.Conv2d.forward ran {cudnn_in_gate} times "
             f"inside the conv kernel's gate under conv_impl='kernel'")
    if totals["conv3x3"] != expected_conv:
        fail(f"{path['name']}: conv3x3 launched {totals['conv3x3']} times, the "
             f"code gives {len(convs)} x {unet_calls[0]} = {expected_conv}")
    return log, totals


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--phases", default=",".join(ALL_PHASES),
                    help="comma-separated subset of " + ",".join(ALL_PHASES))
    ap.add_argument("--paths", default=",".join(p["name"] for p in PATHS),
                    help="comma-separated subset of the main paths")
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--resampling-steps", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log", default=None,
                    help="also append every JSON line to this file")
    ap.add_argument("--verbose-build", action="store_true",
                    help="print nvcc's output (registers, spills)")
    ap.add_argument("--cases", default=None,
                    help="regex: run only the kernel cases whose name matches")
    opt = ap.parse_args(argv)
    global LOG_PATH, CASES
    LOG_PATH = opt.log
    if opt.cases:
        import re
        CASES = re.compile(opt.cases)
    phases = [p for p in opt.phases.split(",") if p]
    unknown = [p for p in phases if p not in ALL_PHASES]
    if unknown:
        fail(f"unknown phases {unknown}")

    if not torch.cuda.is_available():
        fail("no CUDA device: this script measures the port on a GPU and "
             "does not fall back to the CPU")
    t_start = time.time()
    # the checkout must hold the port: fail before any line is printed
    from elasticdiffusion_tpu_torch.kernels import build

    # the port's numerics: fp32 matmuls and fp32 convolutions stay fp32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    emit({"phase": "device", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0]})

    spent = build.build_all()
    for name in build.SOURCES:
        build.load(name)
    emit({"phase": "build", "seconds": spent, "sources": list(build.SOURCES),
          "directory": str(build.build_dir())})
    if opt.verbose_build:
        for name, log in build.build_log.items():
            print(f"--- nvcc {name} ---\n{log}", file=sys.stderr)

    cases = phase_kernels() if "kernels" in phases else []
    checked = {r["log_key"] for r in cases} if "kernels" in phases else None

    logs, totals = {}, collections.Counter()
    if "model" in phases or "requests" in phases:
        from elasticdiffusion_tpu_torch.configs import RuntimeConfig
        from elasticdiffusion_tpu_torch.core.pipeline import ElasticDiffusion
        from elasticdiffusion_tpu_torch.models.registry import load_bundle
        wanted = [p for p in opt.paths.split(",") if p]
        for path in PATHS:
            if path["name"] not in wanted:
                continue
            t0 = time.time()
            bundle = load_bundle(
                path["sd_version"], seed=opt.seed, device="cuda",
                runtime=RuntimeConfig(conv_impl=path["conv_impl"]))
            moved = perturb_bundle(bundle, opt.seed + 1)
            torch.cuda.synchronize()
            emit({"phase": "load", "path": path["name"],
                  "sd_version": path["sd_version"], "seconds": time.time() - t0,
                  "memory_allocated": torch.cuda.memory_allocated(),
                  "perturbed_tensors": moved})
            if "model" in phases:
                with torch.no_grad():
                    phase_model(bundle, path)
            if "requests" in phases:
                pipe = ElasticDiffusion(device="cuda", bundle=bundle,
                                        sd_version=path["sd_version"])
                logs[path["name"]], t = phase_requests(
                    pipe, path, opt.steps, opt.resampling_steps, checked)
                totals.update(t)
                del pipe
            # one bundle at a time on the card
            del bundle
            gc.collect()
            torch.cuda.empty_cache()

    listed = []
    if "kernels" in phases and "requests" in phases:
        seen = set()
        for r in cases:
            by_path = {name: log.get(r["log_key"], 0)
                       for name, log in logs.items()}
            n = sum(by_path.values())
            if n == 0 or r["log_key"] in seen:
                continue  # not a shape of these runs, or its second layout
            seen.add(r["log_key"])
            listed.append({"name": r["name"], "route": r["route"],
                           "source": r["source"], "replaces": r["replaces"],
                           "launches": n, "launches_by_path": by_path,
                           "max_abs_err": r["max_abs_err"],
                           "ms": r["ms"], "plain_ms": r["plain_ms"],
                           "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                           "library_ms": r["library_ms"]})
            for extra in ("body", "splits", "plan", "device_ms",
                          "library_device_ms", "tflops"):
                if extra in r:
                    listed[-1][extra] = r[extra]
        for kernel in totals:
            if not any(e["name"].startswith(kernel + "/") for e in listed):
                fail(f"{kernel}: none of the checked shapes ran on a main path")
        # what each kernel loses on the main paths: launches x (device ms -
        # bound ms), summed, and the shapes that lose the most
        gaps = collections.defaultdict(list)
        for e in listed:
            gaps[e["name"].split("/")[0]].append(
                (e["launches"] * (e["device_ms"] - e["bound_ms"]), e["name"]))
        emit({"phase": "gaps",
              "ms_over_bound": {k: sum(g for g, _ in v) for k, v in gaps.items()},
              "largest": {k: sorted(v, reverse=True)[:6]
                          for k, v in gaps.items()}})

    emit({"phase": "total", "seconds": time.time() - t_start})
    print(smi, flush=True)
    emit({"kernels": listed})
    if (set(phases) != set(ALL_PHASES) or len(logs) != len(PATHS)
            or CASES is not None):
        # a partial run is a tool for development, never the proof
        print(json.dumps({"ok": False, "partial": phases,
                          "paths": sorted(logs)}), flush=True)
        return 0
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
