#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py                     # every phase
    python3 chip_smoke.py --phases kernels    # build + kernel checks only

Phases, each printing one JSON line; any failure exits non-zero:

  device    the card (nvidia-smi name and power limit), torch and CUDA
  build     nvcc builds every kernel from the sources in this checkout
  kernels   every kernel against its plain PyTorch version at the shapes
            the main path gives it, with times from CUDA events
  model     one full-width SD 2.1 UNet forward and one VAE decode with the
            kernels against the same modules with the plain versions
  requests  ElasticDiffusion.generate_image answers two requests at SD 2.1
            full width with seeded random weights; launch counts are read
            around exactly this phase

The last line is {"ok": true, "device": {...}}; the line before it lists
every kernel with its launches on the main path, error, time and bound.
Needs a CUDA device and exits non-zero without one.
"""

from __future__ import annotations

import argparse
import collections
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


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


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
    for S, H in ((4096, 5), (1024, 10), (256, 20)):
        cases.append(("self", bf, 8, S, S, H, 64))
        cases.append(("cross", bf, 8, S, 77, H, 64))
    cases.append(("vae_mid", bf, 1, 6144, 6144, 1, 512))
    cases.append(("vae_mid", bf, 1, 9216, 9216, 1, 512))
    cases.append(("vae_mid", f32, 1, 4096, 4096, 1, 512))
    cases.append(("vae_strip", f32, 1, 704, 704, 1, 512))
    return cases


def run_attention(gen, results):
    import torch.nn.functional as F
    from elasticdiffusion_tpu_torch.kernels.flash_attention import (
        flash_attention, reference_attention)
    for tag, dtype, B, Sq, Sk, H, D in attention_cases():
        # q/k/v as the strided head views of (B, S, H*D) projections
        q = torch.randn(B, Sq, H * D, generator=gen, device="cuda",
                        dtype=torch.float32).to(dtype).view(B, Sq, H, D)
        k = torch.randn(B, Sk, H * D, generator=gen, device="cuda",
                        dtype=torch.float32).to(dtype).view(B, Sk, H, D)
        v = torch.randn(B, Sk, H * D, generator=gen, device="cuda",
                        dtype=torch.float32).to(dtype).view(B, Sk, H, D)
        out = flash_attention(q, k, v)
        torch.cuda.synchronize()
        ref = reference_attention(q, k, v)
        max_abs, rel_l2, tol_abs, tol_rel, why = compare(out, ref)
        ms = time_ms(lambda: flash_attention(q, k, v))
        plain_ms = time_ms(lambda: reference_attention(q, k, v), 1, 5)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt))
        isz = q.element_size()
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * isz
        ops = 4.0 * B * H * Sq * Sk * D
        b_ms, b_by = bound(nbytes, ops, dtype)
        results.append({
            "name": f"flash_attention/{tag}_{str(dtype)[6:]}_{B}x{Sq}x{H}x{D}_Sk{Sk}",
            "kernel": "flash_attention", "route": "cuda",
            "source": "elasticdiffusion_tpu_torch/kernels/csrc/flash_attention.cu",
            "replaces": "elasticdiffusion_tpu/kernels/flash_attention.py:"
                        + ("355" if Sk > 4096 or dtype == torch.float32 else "228"),
            "log_key": ("flash_attention", str(dtype), B, Sq, Sk, H, D),
            "max_abs_err": max_abs, "rel_l2_err": rel_l2,
            "tol_abs": tol_abs, "tol_rel": tol_rel, "tol_why": why,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": lib_ms,
            "library": "F.scaled_dot_product_attention"})
        del q, k, v, out, ref
        torch.cuda.empty_cache()


def run_layernorm(gen, results):
    import torch.nn.functional as F
    from elasticdiffusion_tpu_torch.kernels.layernorm import (
        fused_layer_norm, reference_layer_norm)
    dtype = torch.bfloat16
    for N, C in ((8 * 4096, 320), (8 * 1024, 640), (8 * 256, 1280)):
        x = (torch.randn(N, C, generator=gen, device="cuda") * 1.5 + 0.3).to(dtype)
        w = (1 + 0.1 * torch.randn(C, generator=gen, device="cuda")).to(dtype)
        b = (0.1 * torch.randn(C, generator=gen, device="cuda")).to(dtype)
        out = fused_layer_norm(x, w, b, 1e-5)
        torch.cuda.synchronize()
        ref = reference_layer_norm(x, w, b, 1e-5)
        max_abs, rel_l2, tol_abs, tol_rel, why = compare(out, ref)
        ms = time_ms(lambda: fused_layer_norm(x, w, b, 1e-5))
        plain_ms = time_ms(lambda: reference_layer_norm(x, w, b, 1e-5))
        lib_ms = time_ms(lambda: F.layer_norm(x, (C,), w, b, 1e-5))
        nbytes = (2 * x.numel() + 2 * C) * x.element_size()
        b_ms, b_by = bound(nbytes, 8.0 * N * C, torch.float32)
        results.append({
            "name": f"fused_layer_norm/bfloat16_{N}x{C}",
            "kernel": "fused_layer_norm", "route": "cuda",
            "source": "elasticdiffusion_tpu_torch/kernels/csrc/layernorm.cu",
            "replaces": "elasticdiffusion_tpu/kernels/layernorm.py:66",
            "log_key": ("fused_layer_norm", str(dtype), N, C),
            "max_abs_err": max_abs, "rel_l2_err": rel_l2,
            "tol_abs": tol_abs, "tol_rel": tol_rel, "tol_why": why,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": lib_ms, "library": "F.layer_norm"})


def run_groupnorm(gen, results):
    import torch.nn.functional as F
    from elasticdiffusion_tpu_torch.kernels.groupnorm import (
        fused_group_norm, reference_group_norm)
    dtype = torch.bfloat16
    shapes = ((8, 64, 64, 320), (8, 32, 32, 1280), (8, 64, 64, 960),
              (1, 512, 768, 128))
    for B, H, W, C in shapes:
        x = (torch.randn(B, H, W, C, generator=gen, device="cuda") * 1.5
             + 0.3).to(dtype)
        w = (1 + 0.1 * torch.randn(C, generator=gen, device="cuda")).to(dtype)
        b = (0.1 * torch.randn(C, generator=gen, device="cuda")).to(dtype)
        x_nchw = x.permute(0, 3, 1, 2)  # channels_last view for the library
        for silu in (False, True):
            out = fused_group_norm(x, w, b, 32, 1e-5, silu)
            torch.cuda.synchronize()
            ref = reference_group_norm(x, w, b, 32, 1e-5, silu)
            max_abs, rel_l2, tol_abs, tol_rel, why = compare(out, ref)
            ms = time_ms(lambda: fused_group_norm(x, w, b, 32, 1e-5, silu))
            plain_ms = time_ms(
                lambda: reference_group_norm(x, w, b, 32, 1e-5, silu), 1, 5)
            if silu:
                lib = lambda: F.silu(F.group_norm(x_nchw, 32, w, b, 1e-5))
            else:
                lib = lambda: F.group_norm(x_nchw, 32, w, b, 1e-5)
            lib_ms = time_ms(lib)
            nbytes = (2 * x.numel() + 2 * C) * x.element_size()
            b_ms, b_by = bound(nbytes, 8.0 * x.numel(), torch.float32)
            results.append({
                "name": f"fused_group_norm/bfloat16_{B}x{H}x{W}x{C}"
                        + ("_silu" if silu else ""),
                "kernel": "fused_group_norm", "route": "cuda",
                "source": "elasticdiffusion_tpu_torch/kernels/csrc/groupnorm.cu",
                "replaces": "elasticdiffusion_tpu/kernels/groupnorm.py:94",
                "log_key": ("fused_group_norm", str(dtype), B, H, W, C, silu),
                "max_abs_err": max_abs, "rel_l2_err": rel_l2,
                "tol_abs": tol_abs, "tol_rel": tol_rel, "tol_why": why,
                "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                "bound_by": b_by, "library_ms": lib_ms,
                "library": "F.group_norm" + (" + F.silu" if silu else "")})
        del x, x_nchw
        torch.cuda.empty_cache()


def phase_kernels():
    gen = torch.Generator(device="cuda").manual_seed(0)
    results = []
    run_attention(gen, results)
    run_layernorm(gen, results)
    run_groupnorm(gen, results)
    bad = [r["name"] for r in results
           if not (r["max_abs_err"] <= r["tol_abs"]
                   and r["rel_l2_err"] <= r["tol_rel"])]
    emit({"phase": "kernels",
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


def phase_model(bundle):
    """Kernels against plain versions inside the full-width models."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    dt = bundle.runtime.compute_dtype
    lat = torch.randn(8, 4, 64, 64, generator=gen, device="cuda").to(dt)
    ctx = torch.randn(8, 77, bundle.config.unet.cross_attention_dim,
                      generator=gen, device="cuda").to(dt)
    z = torch.randn(1, 4, 64, 96, generator=gen, device="cuda")
    out = {"phase": "model", "tolerance_rel_l2": 5e-2,
           "tolerance_why": "bf16 activations through the whole network; the "
                            "kernel and plain norms round at different places"}
    res = {}
    for mode in ("auto", "off"):
        bundle.set_use_kernels(mode)
        res[mode] = (bundle.apply_unet(lat, 501.0, ctx), bundle.vae_decode(z))
        # steady state, after the first call's cuDNN and cuBLAS set-up
        out[f"unet_ms_{mode}"] = time_ms(
            lambda: bundle.apply_unet(lat, 501.0, ctx), 1, 5)
        out[f"decode_ms_{mode}"] = time_ms(lambda: bundle.vae_decode(z), 1, 5)
    bundle.set_use_kernels("auto")
    for i, name in enumerate(("unet", "vae_decode")):
        a, b = res["auto"][i], res["off"][i]
        if not torch.isfinite(a.float()).all():
            fail(f"{name} output with kernels is not finite")
        out[f"{name}_shape"] = list(a.shape)
        out[f"{name}_rel_l2"] = rel_l2(a, b)
    emit(out)
    for name in ("unet", "vae_decode"):
        if not out[f"{name}_rel_l2"] <= out["tolerance_rel_l2"]:
            fail(f"{name}: kernels against plain versions rel L2 "
                 f"{out[f'{name}_rel_l2']} over {out['tolerance_rel_l2']}")


def kernel_counts():
    from elasticdiffusion_tpu_torch.kernels.flash_attention import flash_attention
    from elasticdiffusion_tpu_torch.kernels.groupnorm import fused_group_norm
    from elasticdiffusion_tpu_torch.kernels.layernorm import fused_layer_norm
    return {"flash_attention": flash_attention, "fused_layer_norm": fused_layer_norm,
            "fused_group_norm": fused_group_norm}


def plain_cuda_counts():
    from elasticdiffusion_tpu_torch.kernels.attention import dot_product_attention
    from elasticdiffusion_tpu_torch.kernels.groupnorm import group_norm
    from elasticdiffusion_tpu_torch.kernels.layernorm import layer_norm
    return {"attention": dot_product_attention, "layer_norm": layer_norm,
            "group_norm": group_norm}


def phase_requests(pipe, steps: int, resampling: int):
    """The main path. Every launch count is set to 0 just before and read
    just after; comparison launches of the other phases do not count."""
    import elasticdiffusion_tpu_torch.kernels as kernels
    wrappers, plain = kernel_counts(), plain_cuda_counts()
    for w in wrappers.values():
        w.launches = 0
    for d in plain.values():
        d.plain_cuda_calls = 0
    kernels.launch_log = collections.Counter()

    requests = [{"height": 512, "width": 768}, {"height": 768, "width": 768}]
    answers = []
    for i, req in enumerate(requests):
        before = {n: w.launches for n, w in wrappers.items()}
        torch.cuda.reset_peak_memory_stats()
        pipe.seed_everything(i)
        t0 = time.time()
        imgs, info = pipe.generate_image(
            "a photo of a lighthouse on a cliff at dusk", negative_prompts="",
            num_inference_steps=steps, resampling_steps=resampling,
            repaint_sampling=True, return_arrays=True, **req)
        torch.cuda.synchronize()
        wall = time.time() - t0
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
            fail(f"request {req}: image shape {tuple(imgs.shape)}")
        if not finite or lo < 0.0 or hi > 1.0:
            fail(f"request {req}: image not finite or outside [0, 1]")
        if not hi > lo:
            fail(f"request {req}: image is constant")
        if not all(n > 0 for n in launched.values()):
            fail(f"request {req}: a kernel was never launched: {launched}")
    log = kernels.launch_log
    kernels.launch_log = None
    plain_calls = {n: d.plain_cuda_calls for n, d in plain.items()}
    emit({"phase": "requests", "steps": steps, "resampling_steps": resampling,
          "answers": answers, "plain_versions_on_cuda": plain_calls,
          "launches": {n: w.launches for n, w in wrappers.items()}})
    if any(plain_calls.values()):
        fail(f"a plain version stood in for a kernel on the GPU: {plain_calls}")
    return log, {n: w.launches for n, w in wrappers.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--phases", default=",".join(ALL_PHASES),
                    help="comma-separated subset of " + ",".join(ALL_PHASES))
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--resampling-steps", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--verbose-build", action="store_true",
                    help="print nvcc's output (registers, spills)")
    opt = ap.parse_args(argv)
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

    log, totals = collections.Counter(), {}
    if "model" in phases or "requests" in phases:
        from elasticdiffusion_tpu_torch.configs import RuntimeConfig
        from elasticdiffusion_tpu_torch.core.pipeline import ElasticDiffusion
        from elasticdiffusion_tpu_torch.models.registry import load_bundle
        t0 = time.time()
        bundle = load_bundle("2.1", runtime=RuntimeConfig(), seed=opt.seed,
                             device="cuda")
        torch.cuda.synchronize()
        emit({"phase": "load", "sd_version": "2.1", "seconds": time.time() - t0,
              "memory_allocated": torch.cuda.memory_allocated()})
        if "model" in phases:
            with torch.no_grad():
                phase_model(bundle)
        if "requests" in phases:
            pipe = ElasticDiffusion(device="cuda", sd_version="2.1",
                                    bundle=bundle)
            log, totals = phase_requests(pipe, opt.steps, opt.resampling_steps)

    listed = []
    if "kernels" in phases and "requests" in phases:
        for r in cases:
            n = log.get(r["log_key"], 0)
            if n == 0:
                continue  # checked above, but not a shape of this run
            listed.append({"name": r["name"], "route": r["route"],
                           "source": r["source"], "replaces": r["replaces"],
                           "launches": n, "max_abs_err": r["max_abs_err"],
                           "ms": r["ms"], "plain_ms": r["plain_ms"],
                           "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                           "library_ms": r["library_ms"]})
        for kernel in totals:
            if not any(e["name"].startswith(kernel + "/") for e in listed):
                fail(f"{kernel}: none of the checked shapes ran on the main path")

    emit({"phase": "total", "seconds": time.time() - t_start})
    print(smi, flush=True)
    emit({"kernels": listed})
    if set(phases) != set(ALL_PHASES):
        # a partial run is a tool for development, never the proof
        print(json.dumps({"ok": False, "partial": phases}), flush=True)
        return 0
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
