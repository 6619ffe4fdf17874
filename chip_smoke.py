#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py                     # every phase, every path
    python3 chip_smoke.py --phases kernels    # build + kernel checks only
    python3 chip_smoke.py --paths sd15 --log smoke.jsonl   # one path; the
                                              # JSON lines also go to a file
    python3 chip_smoke.py --phases device,build,kernels --cases 'conv3x3/sd15'
                                              # only the kernel cases whose
                                              # name matches a regex
    python3 chip_smoke.py --phases device,build,kernels,decode --paths sdxl \
        --cases 'group_norm_|vae_' --chunk-budgets 67108864,268435456
                                              # the decode routes, and the
                                              # streamed one at other slab
                                              # budgets
    python3 chip_smoke.py --phases device,build,kernels,apps
                                              # checkpoints and the apps
    python3 chip_smoke.py --phases device,build,kernels,mesh \
        --cases 'sdxl_bfloat16_[41]x|_1x(128|256|512|64)x|32768'
                                              # two ranks: the elastic step
                                              # and the halo decode split

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
  api       the scheduler and geometry API around the pipeline at SDXL's
            2048x2048 px geometry: get_views, compute_downsampling_size,
            nearest_pick_indices, then on (1, 4, 256, 256) latents in fp32
            and bf16 DDIMScheduler's add_noise, 50 steps of
            scale_model_input and step, and undo_step_from_coeffs, on the
            card and on the CPU from the same draws; fails unless the card's
            results keep their device and dtype and agree with the CPU's
            within API_TOL_REL
  model     per bundle, one full-width batch-8 UNet forward and one VAE
            decode with the kernels against the same modules with the plain
            versions; for the bundles that run the conv kernel and the fp32
            ones, the forward with conv_impl='kernel' against
            conv_impl='cudnn' (fp32: also the forward with cuDNN in TF32);
            for the SDXL ControlNet bundle, one batch-8 ControlNet + UNet
            forward with every kernel against every plain version and cuDNN
            convs
  graphs    per bundle that lists `graph_rows`, the UNet forward through
            ModelBundle.apply_unet's CUDA graphs (models/unet_graphs.py)
            at the benchmark cells' keys: SD 2.1 16 and 2 rows at 64x64,
            SDXL 22, 16, 4 and 2 rows at 128x128, one --fp32 key (sd21_fp32)
            and one ControlNet key (sdxl_canny, the ControlNet eager, its
            residuals static inputs). Each key's first call must run eagerly,
            its second capture, its third replay; both graph outputs are held
            to the module's eager forward of the same inputs (max |d|,
            expected 0), a replay at another timestep too. Prints the host's
            launch calls and the device's ops of one eager call and of one
            replay (torch.profiler), enqueue and CUDA-event ms of both, the
            allocator's bytes before and after the captures beside the
            graphs' static tensors. Aliasing guard: every key replayed, then
            key A, key B and A again on new inputs; the tensors returned
            before must not change. Reload: every UNet weight scaled in
            place by convert.load_into, a replay must equal the eager
            forward of the new weights, and again of the old ones once
            they are back. Fails unless a replay counts the same wrapper
            launches and launch-log entries as an eager call of its key,
            with every kernel the bundle runs among them. For sdxl_canny
            also the ControlNet and the UNet as a pair of graphs
            (apply_unet with a condition; `pair_rows` 16, one image
            broadcast, 4 and 2 at 128x128): eager, capture, replay, each
            and a replay at another timestep and condition equal to the
            modules' eager forwards (max |d| 0); the UNet graph must read
            the ControlNet graph's residuals where they lie and a replay
            count an eager pair's kernels; launches, ms (the ControlNet
            alone too), the static conditions' bytes
  requests  ElasticDiffusion.generate_image answers requests at full width
            with seeded random weights on seven paths, one bundle at a time:
            SDXL 1.0 and SD 1.5 with conv_impl='kernel', SD 2.1 with the
            default conv_impl='cudnn', ControlNet text2img on SDXL 1.0
            (canny) and SD 1.5 (depth, through the port's DPT-large), both
            with conv_impl='kernel', and --fp32 (fp32 weights and compute,
            2 steps) under PyTorch's default TF32 flags: SD 1.5 through the
            CLI's main() with --fp32 true and SD 2.1 with conv_impl='kernel';
            on those a hook inside every UNet forward must read cuDNN's TF32
            flag False. SDXL also answers 2048x2048 px (16
            views in one batch) with tiled_decoder=True; SD 2.1 768x768 px
            with the overlap-averaged tiles of a low_vram pipe (their mean
            absolute difference from the monolithic decode is printed); SD
            1.5 runs its first request again cut after two steps with
            checkpoint_every=2 and resumes from the file, and fails unless
            the final latent is the uninterrupted run's (rel L2 within
            RESUME_TOL_REL_L2). Launch counts are set to 0 just before
            each path and read just after; `unchecked_launches` lists the
            shapes a path launched that the kernels phase did not check, and
            any shape among them fails the run. Then the path's first request
            runs again with every plain version and cuDNN convs, same seed:
            its final latents are held to the kernels' (`end_to_end`, rel L2
            within E2E_TOL_REL_L2, E2E_FP32_TOL_REL_L2 on the fp32 paths),
            and the random draws of the two runs must
            be the same. A ControlNet path also fails when the RMS of the
            ControlNet's mid residual or first down residual is 0 at the
            first step of its first request, and unless some call replays
            a pair and, right after each such call, the residuals its
            ControlNet graph left in the pool are the ControlNet's eager
            forward on the static inputs the call loaded (rel L2 within
            PAIR_RESIDUAL_REL_L2): else a replay did not run the
            ControlNet. (Checked after the request instead, they may hold
            what a later call's graph wrote over them: the graphs share a
            pool.) The ControlNet calls
            that the conv3x3 count expects come from the bundle's own
            counters, which a replay adds to whether or not it ran
  apps      on the sd15_depth bundle: the bundle written as a diffusers
            checkpoint directory (safetensors, its own dtypes) and the
            smoke's DPT-large as a transformers one, read back with
            load_bundle(checkpoint_dir=...) (every tensor equal); then the
            CLI (512x768), the ControlNet CLI (depth through ED_DPT_DIR) and
            the PCA app (512x512) each through its main(), from that
            directory; the two CLI images must equal the same requests on
            the source bundle in every uint8 value, the PCA app must write
            its images and report torch.cuda memory; launches checked as for
            a path
  decode    on the SDXL bundle one latent at 256x256 (2048x2048 px, fp32)
            and on the SD 2.1 bundle one at 96x96 (bf16), each through
            decode_latents, halo_decode(streamed=False),
            halo_decode(streamed=True) and the approximate bands
            halo_decode(num_bands=4): seconds, CUDA-event ms, peak bytes,
            the branch halo_decode's default choice takes there, launches
            checked as for a path; fails when the monolithic or streamed
            halo route is further than DECODE_TOL_REL_L2 from
            decode_latents, or the band route further than that from the
            same route on the plain versions (its distance from
            decode_latents is printed)
  mesh      SDXL 1.0 (the sdxl path's bundle and perturbation) on a (1, 2)
            mesh of two spawned ranks (both on cuda:0 under gloo on one
            GPU, one GPU a rank under NCCL on two), one request at
            1024x2048 px with tiled_decoder=True: each rank runs half of
            every UNet batch (its rows counted at apply_unet) and one band
            of the halo decode's stage b. Fails unless the ranks' final
            latents, images and mesh decodes are bitwise equal, the final
            latent is within E2E_TOL_REL_L2 of the same request on one GPU
            (rank 0), the mesh decode within MESH_DECODE_TOL_REL_L2 of
            decode_latents, and each rank's launches pass the requests
            phase's checks. Prints per rank the collective inventory (counts,
            bytes, routes), peak bytes, denoise and decode seconds: with two
            ranks on one card these are not a speed

Every path of the requests phase, each decode phase, the apps phase and
each mesh rank also prints `cpu_conv_calls`, the convolutions that ran
under the port's CPU convolution rule (models/layers.py `conv2d`:
contiguous operands on a CPU tensor), and fails unless it is 0: a card path
runs no convolution on the CPU.

Every bundle's biases and norm weights (the ControlNet's and the DPT's
too) are moved off their seeded init (`perturb_bundle`) as soon as it
loads, so that a bias or norm parameter wired to the wrong place shows in
the model and end-to-end checks. The port's seeded init gives the
ControlNet's zero convolutions lecun-normal weights where Flax gives zeros,
so at random weights its residuals are not 0 and a run can see them.

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

from elasticdiffusion_tpu_torch import kernels
from elasticdiffusion_tpu_torch.models.layers import conv2d
from elasticdiffusion_tpu_torch.utils.flops import (H100_BF16_TFLOPS,
                                                    H100_FP32_TFLOPS,
                                                    H100_HBM_GBPS)

# published peaks of one H100 SXM (dense): the yardstick of bound_ms
PEAK_BYTES_PER_S = H100_HBM_GBPS * 1e9
PEAK_OPS_PER_S = {torch.bfloat16: H100_BF16_TFLOPS * 1e12,
                  torch.float32: H100_FP32_TFLOPS * 1e12}
# the TF32 tensor-core peak (data sheet), for the floor of the fp32 bodies
# that run three TF32 passes
PEAK_TF32_OPS_PER_S = 495e12

ALL_PHASES = ("device", "build", "kernels", "api", "model", "graphs",
              "requests", "decode", "apps", "mesh")

# The mesh phase: SDXL 1.0 at 1024x2048 px on a (1, MESH_WORLD) mesh. Its
# UNet batches (direction 8 rows, repaint direction 2, 4 views) split into
# MESH_BATCHES rows a rank; its 128x256 latent splits into MESH_WORLD bands
MESH_WORLD = 2
MESH_BATCHES = (4, 1)
MESH_LATENT = (128, 256)


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


def fma_bound_ms(ops: float) -> float:
    """fp32 operations over the CUDA cores' fp32 peak: the bound of an fp32
    body on the FMA units, kept beside the bound of a body in three TF32
    passes (which can beat it)."""
    return ops / PEAK_OPS_PER_S[torch.float32] * 1e3


def bound(nbytes: float, ops: float, dtype, tf32x3: bool = False) -> tuple:
    """(ms, "bytes" | "operations"): the larger of the bytes over the memory
    rate and the operations over the peak of the units that do them. A body
    in three TF32 passes does three times the operations on the TF32 tensor
    cores."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = (3.0 * ops / PEAK_TF32_OPS_PER_S if tf32x3
             else ops / PEAK_OPS_PER_S[dtype]) * 1e3
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
    # the SDXL 2048x2048 request runs its 16 views in one batch; each rank
    # of the mesh phase runs 4 and 1 rows
    for S, H, D in ((4096, 10, 64), (1024, 20, 64)):
        for B in (16,) + MESH_BATCHES:
            cases.append(("self", bf, B, S, S, H, D))
            cases.append(("cross", bf, B, S, 77, H, D))
    cases.append(("vae_mid", bf, 1, 6144, 6144, 1, 512))
    cases.append(("vae_mid", bf, 1, 9216, 9216, 1, 512))
    # the apps phase's PCA app decodes SD 1.5 at 512x512 px
    cases.append(("vae_mid", bf, 1, 4096, 4096, 1, 512))
    # SD 2.1's low_vram tiles (48x48 latents) and decodes at 768x768 px
    cases.append(("vae_mid", bf, 1, 2304, 2304, 1, 512))
    cases.append(("vae_mid", f32, 1, 4096, 4096, 1, 512))
    cases.append(("vae_strip", f32, 1, 704, 704, 1, 512))
    # SDXL decodes in fp32 (force_upcast): 1024x1536 px is 128x192 tokens,
    # 1536x1536 px 192x192; its background strips encode at 21 and 22 rows
    cases.append(("vae_mid", f32, 1, 24576, 24576, 1, 512))
    cases.append(("vae_mid", f32, 1, 36864, 36864, 1, 512))
    # SDXL at 2048x2048 px: 256x256 tokens (its plain version runs in query
    # blocks: the whole logit matrix would take 17 GB)
    cases.append(("vae_mid", f32, 1, 65536, 65536, 1, 512))
    # SDXL at 1024x2048 px, the mesh phase: 128x256 tokens on every rank
    cases.append(("vae_mid", f32, 1, 32768, 32768, 1, 512))
    cases.append(("vae_strip", f32, 1, 2688, 2688, 1, 512))
    cases.append(("vae_strip", f32, 1, 2816, 2816, 1, 512))
    # the --fp32 paths: every UNet attention in fp32, at SD 1.5's head dims
    # (sd15_fp32), SD 2.1's (sd21_fp32) and SDXL's, at the batches the
    # requests give (8, 2, 3); their VAE decodes in fp32 at 512x768 px
    for S, H, D in ((4096, 8, 40), (1024, 8, 80), (256, 8, 160),
                    (4096, 5, 64), (1024, 10, 64), (256, 20, 64),
                    (4096, 10, 64), (1024, 20, 64)):
        for B in (8, 2, 3):
            cases.append(("self", f32, B, S, S, H, D))
            cases.append(("cross", f32, B, S, 77, H, D))
    cases.append(("vae_mid", f32, 1, 6144, 6144, 1, 512))
    for D in (40, 80, 160):  # the fp32 UNet head dims at a shape no path gives
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
    f32 = torch.float32
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
        plain = (lambda: blocked_reference_attention(q, k, v)) \
            if Sq * Sk > PLAIN_LOGITS else (lambda: reference_attention(q, k, v))
        ref = plain()
        max_abs, rel_l2, tol_abs, tol_rel, why = compare(out, ref)
        isz = q.element_size()
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * isz
        ops = 4.0 * B * H * Sq * Sk * D
        plan = attention_plan(dtype, B, Sq, Sk, H, D)
        b_ms, b_by = bound(nbytes, ops, dtype, plan.body == "mma.tf32x3")
        # the fp32 UNet cases at batches 2 and 3 take fewer samples
        light = dtype == f32 and D != 512 and B != 8
        reps = (1, 5) if b_ms > 5.0 or light else (3, 15)
        ms = time_ms(lambda: flash_attention(q, k, v), *reps)
        plain_ms = time_ms(plain, 1, 2 if light else 5)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        sdpa = lambda: F.scaled_dot_product_attention(qt, kt, vt)
        lib_ms = time_ms(sdpa, *reps)
        extra = {}
        if dtype == f32 and D != 512:
            # which backend SDPA picked for fp32, and its error
            lib_out = sdpa().transpose(1, 2)
            lib_abs, lib_rel = compare(lib_out, ref)[:2]
            extra = {"library_backend": sdpa_backend(qt, kt, vt, lib_out),
                     "library_max_abs_err": lib_abs,
                     "library_rel_l2_err": lib_rel}
            del lib_out
        # short calls again without the host: about 2 ms of launches a replay
        n = max(1, min(20, int(2.0 / ms)))
        device_ms = graph_ms(lambda: flash_attention(q, k, v), n,
                             3 if light else 5)
        lib_device_ms = graph_ms(sdpa, n, 3 if light else 5)
        if plan.body == "mma.tf32x3":
            extra["fma_bound_ms"] = fma_bound_ms(ops)
        results.append({
            "name": f"flash_attention/{tag}_{str(dtype)[6:]}_{B}x{Sq}x{H}x{D}_Sk{Sk}",
            "kernel": "flash_attention", "route": "cuda",
            "source": "elasticdiffusion_tpu_torch/kernels/csrc/flash_attention.cu",
            "replaces": "elasticdiffusion_tpu/kernels/flash_attention.py:"
                        + ("355" if D == 512 else "228"),
            "log_key": ("flash_attention", str(dtype), B, Sq, Sk, H, D),
            "body": plan.body, "splits": plan.splits,
            "max_abs_err": max_abs, "rel_l2_err": rel_l2,
            "tol_abs": tol_abs, "tol_rel": tol_rel,
            "tol_why": why + ("; the kernel's products in three TF32 passes "
                              "(the dropped lo*lo below 2^-21 of a product)"
                              if plan.body == "mma.tf32x3" else ""),
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": lib_ms,
            "device_ms": device_ms, "library_device_ms": lib_device_ms,
            "library": "F.scaled_dot_product_attention", **extra,
            "plain": "reference_attention" + (
                f" in query blocks of {PLAIN_LOGITS // Sk}"
                if Sq * Sk > PLAIN_LOGITS else "")})
        del q, k, v, out, ref
        torch.cuda.empty_cache()


def sdpa_backend(qt, kt, vt, lib_out) -> str:
    """The backend F.scaled_dot_product_attention took: the one of those
    that run alone on these inputs whose output is bitwise the default
    call's."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    for backend in (SDPBackend.CUDNN_ATTENTION, SDPBackend.FLASH_ATTENTION,
                    SDPBackend.EFFICIENT_ATTENTION, SDPBackend.MATH):
        try:
            with sdpa_kernel([backend]):
                out = F.scaled_dot_product_attention(qt, kt, vt)
        except RuntimeError:
            continue
        if torch.equal(out.transpose(1, 2), lib_out):
            return backend.name
    return "unknown"


# logits (query rows x keys) the plain attention takes in one piece; longer
# inputs are compared in blocks of query rows
PLAIN_LOGITS = 1 << 29


def blocked_reference_attention(q, k, v):
    """reference_attention over blocks of query rows: each row's softmax
    sees every key, so the result is the whole call's; the logits of one
    block stay within PLAIN_LOGITS elements."""
    from elasticdiffusion_tpu_torch.kernels.flash_attention import (
        reference_attention)
    n = max(1, PLAIN_LOGITS // k.shape[1])
    return torch.cat([reference_attention(q[:, i:i + n], k, v)
                      for i in range(0, q.shape[1], n)], dim=1)


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
    the requests give: 8, 2, 3 and 9 as for attention, 16 for SDXL at
    2048x2048, 4 and 1 on a rank of the mesh phase; SD 1.5's 512x768
    request has 3 views) and the text encoders' 77 tokens. Both keep their
    weights in the parameter dtype (bf16; fp32 on the --fp32 paths, whose
    activations are fp32 too) and use eps 1e-5 (LayerNorm32's default,
    CLIPTextConfig.layer_norm_eps). Every case is timed in full."""
    bf, f32 = torch.bfloat16, torch.float32
    sd = ((4096, 320), (1024, 640), (256, 1280), (64, 1280))
    unet = (("sdxl", bf, ((4096, 640), (1024, 1280)),
             (8, 2, 3, 9, 16) + MESH_BATCHES),
            ("sd15", bf, sd, (8, 2, 3)),
            ("sd21", bf, sd, (8, 2, 3, 9)),
            ("sd_fp32", f32, sd, (8, 2, 3)))
    cases, seen = [], set()
    for tag, dtype, shapes, batches in unet:
        for S, C in shapes:
            for B in batches:
                if (dtype, B * S, C) not in seen:
                    seen.add((dtype, B * S, C))
                    cases.append((tag, dtype, dtype, 1e-5, B * S, C))
    for C in (768, 1280, 1024):  # CLIP L (SD 1.x, SDXL), bigG, OpenCLIP H
        cases.append(("clip", bf, bf, 1e-5, 77, C))
    for C in (768, 1024):        # CLIP L and OpenCLIP H in fp32
        cases.append(("clip", f32, f32, 1e-5, 77, C))
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
    library's device time too. `lib` None: no one PyTorch call computes the
    same function."""
    reps = (3, 15) if full else (1, 3)
    out = {"ms": time_ms(kernel, *reps),
           "plain_ms": time_ms(plain, 1, 5 if full else 1),
           "library_ms": None if lib is None else time_ms(lib, *reps)}
    # about 2 ms of launches a replay
    n = max(1, min(20, int(2.0 / out["ms"])))
    out["device_ms"] = graph_ms(kernel, n, 5 if full else 3)
    out["library_device_ms"] = graph_ms(lib, n) if full and lib else None
    return out


def groupnorm_cases():
    """(tag, dtype, weight dtype, eps, B, H, W, C, silu, full) of every
    GroupNorm the paths launch, with the weight dtype and eps of the module
    that launches it: the UNet's ResNet norms (SiLU, eps 1e-5) and
    Transformer2D norms (no SiLU, eps 1e-6), bf16 weights, at the batches
    the requests give (16: the SDXL 2048x2048 request's views; 4 and 1: a
    rank of the mesh phase); the VAE decoders (bf16 activations with the fp32 norm
    weights of the compute copy for SD 1.x / 2.x, fp32 for the SDXL
    force_upcast decode) and the fp32 background-strip encodes, all eps 1e-6.
    The --fp32 paths' UNets: the SD 1.x / 2.x shapes in fp32 with fp32
    weights. `full` (timed in full): batch 8, and every VAE shape."""
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

    for tag, dtype, shapes, batches in (
            ("sdxl", bf, sdxl, (8, 2, 3, 9, 16) + MESH_BATCHES),
            ("sd15", bf, sd, (8, 2, 3)), ("sd21", bf, sd, (8, 2, 3, 9)),
            ("sd_fp32", f32, sd, (8, 2, 3))):  # the --fp32 paths' UNets
        for S, C, silu in shapes:
            for B in batches:
                add(tag, dtype, dtype, 1e-5 if silu else 1e-6, B, S, S, C,
                    silu)
    # decoders at latent (h, w): mid block (and its attention's norm), the
    # four up blocks, norm_out. SD 1.x / 2.x bf16 at 512x768 and 768x768
    # px, SD 2.1's low_vram tiles (48x48 latents) and the apps phase's PCA
    # app at 512x512 px; SDXL fp32 at 1024x1536, 1536x1536, 2048x2048 px
    # and 1024x2048 px (the mesh phase: stage a on every rank); SD 1.5 and
    # 2.1 fp32 (the --fp32 paths) at 512x768 px
    for dtype, latents in ((bf, ((64, 96), (96, 96), (48, 48), (64, 64))),
                           (f32, ((128, 192), (192, 192), (256, 256),
                                  MESH_LATENT, (64, 96)))):
        for h, w in latents:
            for k, C, silu in ((1, 512, F_), (1, 512, T), (2, 512, T),
                               (4, 512, T), (4, 256, T), (8, 256, T),
                               (8, 128, T)):
                add("vae_decode", dtype, f32, 1e-6, 1, k * h, k * w, C, silu)
    # the band route of the decode phase (halo_decode(num_bands=
    # DECODE_BANDS) at DEFAULT_HALO): stage b on every band's window of rows
    from elasticdiffusion_tpu_torch.configs import get_bundle_config
    from elasticdiffusion_tpu_torch.parallel.halo_decode import band_norm_shapes
    for p in PATHS:
        if "decode" in p:
            cfg = get_bundle_config(p["sd_version"]).vae
            dtype = f32 if cfg.force_upcast else bf
            for (B, H, W, C), silu in band_norm_shapes(cfg, 1, *p["decode"],
                                                       DECODE_BANDS):
                add("vae_bands", dtype, f32, 1e-6, B, H, W, C, silu)
    # fp32 encoders of the background strips (image rows x width): SD 1.x /
    # 2.x 88x512, SDXL 168x1024, 176x1024 and 256x1024 (the mesh phase's
    # 1024x2048 px request, on every rank)
    for H, W in ((88, 512), (168, 1024), (176, 1024), (256, 1024)):
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




def halves_cases():
    """(half, dtype, B, H, W, C) of every launch of group_norm_sums and
    group_norm_apply (SiLU: every apply of the decoder is followed by one)
    in the streamed decodes of the decode phase (the paths' "decode"
    latents) and on a rank of the mesh phase's decode, in the VAE's decode
    dtype, from parallel/halo_decode.py's own enumerations; the decode and
    mesh phases confirm them against their launch logs."""
    from elasticdiffusion_tpu_torch.configs import get_bundle_config
    from elasticdiffusion_tpu_torch.parallel.halo_decode import (
        mesh_norm_shapes, streamed_norm_shapes)
    cases = []
    runs = [(p["sd_version"], streamed_norm_shapes, p["decode"]) for p in PATHS
            if "decode" in p]
    runs.append(("XL1.0", lambda cfg, B, h, w: mesh_norm_shapes(
        cfg, B, h, w, MESH_WORLD), MESH_LATENT))
    for version, shapes, (h, w) in runs:
        cfg = get_bundle_config(version).vae
        dtype = torch.float32 if cfg.force_upcast else torch.bfloat16
        for half, shape, _ in shapes(cfg, 1, h, w):
            if (half, dtype) + shape not in cases:
                cases.append((half, dtype) + shape)
    return cases


def run_halves(gen, results):
    """The two halves of the GroupNorm kernel against their plain versions
    at every shape the streamed decodes launch."""
    from elasticdiffusion_tpu_torch.kernels.groupnorm import (
        group_norm_apply, group_norm_sums, reference_group_norm_apply,
        reference_group_norm_sums)
    for half, dtype, B, H, W, C in halves_cases():
        name = f"group_norm_{half}/vae_{str(dtype)[6:]}_{B}x{H}x{W}x{C}"
        if not wanted(name):
            continue
        x = (torch.randn(B, H, W, C, generator=gen, device="cuda") * 1.5
             + 0.3).to(dtype)
        if half == "sums":
            kernel = lambda: group_norm_sums(x)
            plain = lambda: reference_group_norm_sums(x)
            nbytes = x.numel() * x.element_size() + 2 * B * C * 4
            ops, key = 3.0 * x.numel(), ("group_norm_sums", str(dtype), B, H, W, C)
        else:
            sc = 1 + 0.1 * torch.randn(B, C, generator=gen, device="cuda")
            sh = 0.1 * torch.randn(B, C, generator=gen, device="cuda")
            kernel = lambda: group_norm_apply(x, sc, sh, True)
            plain = lambda: reference_group_norm_apply(x, sc, sh, True)
            nbytes = 2 * x.numel() * x.element_size() + 2 * B * C * 4
            ops = 6.0 * x.numel()
            key = ("group_norm_apply", str(dtype), str(torch.float32), B, H,
                   W, C, True)
        out = kernel()
        torch.cuda.synchronize()
        ref = plain()
        max_abs, rel_l2, tol_abs, tol_rel, why = compare(out, ref)
        if half == "sums":
            why += ("; the kernel sums each channel over row chunks and then "
                    "the chunks, the plain version in torch's order")
        b_ms, b_by = bound(nbytes, ops, torch.float32)
        results.append({
            "name": name, "kernel": f"group_norm_{half}", "route": "cuda",
            "source": "elasticdiffusion_tpu_torch/kernels/csrc/groupnorm.cu",
            "replaces": "elasticdiffusion_tpu/kernels/groupnorm.py:"
                        + ("94" if half == "sums" else "119"),
            "log_key": key, "body": "gn_stats" if half == "sums" else "gn_apply",
            "max_abs_err": max_abs, "rel_l2_err": rel_l2,
            "tol_abs": tol_abs, "tol_rel": tol_rel, "tol_why": why,
            "bound_ms": b_ms, "bound_by": b_by, "library": None,
            **norm_times(kernel, plain, None, True)})
        del x, out, ref
        if nbytes > (256 << 20):
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
    # 512x768 request has 3 views), 16 (the SDXL 2048x2048 request's
    # views), 4 and 1 (a rank of the mesh phase)
    for tag, shapes, batches in (("sdxl", sdxl, (8, 2, 3, 9, 16) + MESH_BATCHES),
                                 ("sd15", sd15, (8, 2, 3))):
        for S, C, O in shapes:
            for B in batches:
                cases.append((tag, bf, B, S, S, C, O, False, bf))
    # the sd21_fp32 path (conv_impl="kernel"): SD 2.1's UNet has SD 1.5's
    # convolutions, in fp32 with fp32 biases; the two upsample convs, which
    # the bf16 paths share with SDXL's list, are added
    for S, C, O in sd15 + ((32, 1280, 1280), (64, 640, 640)):
        for B in (8, 2, 3):
            cases.append(("sd15", f32, B, S, S, C, O, False, f32))
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
        # the fp32 path shapes at batches 2 and 3 take fewer samples
        light = tag == "sd15" and dtype == torch.float32 and B != 8
        reps = (1, 5) if light else (3, 15)
        ms = time_ms(kernel, *reps)
        plain_ms = time_ms(lambda: reference_conv3x3(x, w, bias, silu), 1,
                           2 if light else 3)
        lib_bias = None if bias is None else bias.to(dtype)
        if silu:
            lib = lambda: F.silu(F.conv2d(x_nchw, w_oihw, lib_bias, padding=1))
        else:
            lib = lambda: F.conv2d(x_nchw, w_oihw, lib_bias, padding=1)
        lib_ms = time_ms(lib, *reps)
        extra = {}
        if dtype == torch.float32:
            # cuDNN in full fp32 (TF32 off): its error against the plain
            # version
            lib_abs, lib_rel = compare(lib().permute(0, 2, 3, 1), ref)[:2]
            extra = {"library_max_abs_err": lib_abs,
                     "library_rel_l2_err": lib_rel}
        # again without the host: about 2 ms of launches a replay
        n = max(1, min(20, int(2.0 / ms)))
        device_ms = graph_ms(kernel, n, 3 if light else 5)
        lib_device_ms = graph_ms(lib, n, 3 if light else 5)
        plan = conv_plan(dtype, B, H, W, C, O)
        nbytes = (x.numel() + w.numel() + out.numel()) * x.element_size() \
            + (0 if bias is None else bias.numel() * bias.element_size())
        ops = 2.0 * 9 * C * O * B * H * W
        b_ms, b_by = bound(nbytes, ops, dtype, plan.body == "mma.tf32x3")
        if plan.body == "mma.tf32x3":
            extra["fma_bound_ms"] = fma_bound_ms(ops)
        results.append({
            "name": name, "kernel": "conv3x3", "route": "cuda",
            "source": "elasticdiffusion_tpu_torch/kernels/csrc/conv3x3.cu",
            "replaces": "elasticdiffusion_tpu/kernels/conv3x3.py:166",
            "log_key": ("conv3x3", str(dtype), B, H, W, C, O, silu),
            "max_abs_err": max_abs, "rel_l2_err": rel_l2,
            "tol_abs": tol_abs, "tol_rel": tol_rel,
            "tol_why": why + ("; both sides sum the 9*C exact products in fp32"
                              if dtype == torch.bfloat16 else
                              "; the kernel's products in three TF32 passes "
                              "(the dropped lo*lo below 2^-21 of a product)"),
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": lib_ms,
            "device_ms": device_ms, "library_device_ms": lib_device_ms,
            "tflops": ops / device_ms / 1e9,
            "body": plan.body, "splits": plan.splits,
            "plan": {"tile": list(plan.tile), "bn": plan.bn,
                     "stages": plan.stages, "blocks": plan.blocks},
            "library": "F.conv2d" + (" + F.silu" if silu else ""), **extra})
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
    run_halves(gen, results)
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


# The api phase: the scheduler and geometry functions a library user calls
# around the pipeline, at SDXL's 2048x2048 px latent through a 50-step
# schedule on the card, each call held to the same call on the CPU on the
# same inputs. The repaint re-noise runs at step API_UNDO_STEP's timestep
API_PIXELS = 2048
API_NATIVE = 1024
API_STEPS = 50
API_UNDO_STEP = 25
# largest difference allowed, over the CPU result's largest magnitude. A
# call's ops are the same on both devices, but CUDA divides by a scalar as a
# product with its reciprocal: fp32 results differ in their last bits, and
# bf16 results (computed in fp32) by one rounding step
API_TOL_REL = {torch.float32: 1e-6, torch.bfloat16: 2.0 ** -7}


def phase_api(device="cuda") -> dict:
    """get_views, compute_downsampling_size and nearest_pick_indices at the
    SDXL 2048x2048 px geometry; DDIMScheduler's set_timesteps, add_noise,
    then API_STEPS of scale_model_input and step, then
    undo_step_from_coeffs, on (1, 4, 256, 256) latents in fp32 and bf16 on
    `device` from seeded draws, each call run again on the CPU on the same
    inputs. Fails unless every result keeps its device and dtype and lies
    within API_TOL_REL of the CPU's. Also prints how far the card's 50-step
    chain ends from the same chain run wholly on the CPU."""
    from elasticdiffusion_tpu_torch.ops.resample import (
        build_resample_plan, compute_downsampling_size, get_downsample_size,
        nearest_pick_indices)
    from elasticdiffusion_tpu_torch.ops.views import get_views, get_views_latent
    from elasticdiffusion_tpu_torch.sched.ddim import DDIMScheduler
    t_start = time.time()
    dev_type = torch.device(device).type
    lh = lw = API_PIXELS // 8
    views = get_views(API_PIXELS, API_PIXELS)
    down = get_downsample_size(API_PIXELS, API_PIXELS, API_NATIVE)
    size = compute_downsampling_size(lh, lw, API_NATIVE / API_PIXELS)
    blocks = build_resample_plan(lh, lw, *down).num_blocks
    pick = nearest_pick_indices(blocks, device=device)
    out = {"phase": "api", "device": str(pick.device), "latent": [1, 4, lh, lw],
           "steps": API_STEPS, "views": len(views),
           "downsampling_size": list(size), "pick_blocks": blocks,
           "tolerance_rel": {str(k): v for k, v in API_TOL_REL.items()}}
    if views != get_views_latent(lh, lw, 64, 64, 32) or size != down:
        fail(f"api: get_views or compute_downsampling_size off the latent "
             f"geometry: {len(views)} views, {size} against {down}")
    if not (pick.dtype == torch.int32 and pick.device.type == dev_type
            and pick.shape == (blocks,) and not pick.any()):
        fail(f"api: nearest_pick_indices gave {pick.dtype} {pick.device} "
             f"{tuple(pick.shape)}")
    sched = DDIMScheduler()
    state = sched.set_timesteps(API_STEPS)
    ts = [int(t) for t in state.timesteps]
    gen = torch.Generator().manual_seed(11)
    shape = (1, 4, lh, lw)
    x0 = torch.randn(shape, generator=gen)
    eps = torch.randn((API_STEPS + 1,) + shape, generator=gen)
    s1mb, sb = sched.undo_step_coeffs(state, ts[API_UNDO_STEP])
    noises = torch.randn((len(s1mb),) + shape, generator=gen)

    def chain(dev, dtype, held=None):
        """The calls in turn on `dev`; held(name, result, call) runs the
        call again on the CPU's copies of its inputs."""
        held = held or (lambda name, r, call: None)

        def cast(t):
            return t.to(device=dev, dtype=dtype)
        e0, clean = cast(eps[0]), cast(x0)
        x = sched.add_noise(clean, e0, ts[0])
        held("add_noise", x, lambda c: sched.add_noise(c(clean), c(e0), ts[0]))
        for i in range(API_STEPS):
            if sched.scale_model_input(x, ts[i]) is not x:
                fail("api: scale_model_input is not the identity")
            e = cast(eps[i + 1])
            res = sched.step(state, e, i, x)
            held("step", res, lambda c: sched.step(state, c(e), i, c(x)))
            x = res[0]
        n = cast(noises)
        res = sched.undo_step_from_coeffs(x, n, s1mb, sb)
        held("undo_step_from_coeffs", res,
             lambda c: sched.undo_step_from_coeffs(c(x), c(n), s1mb, sb))
        return res

    bad = []
    for dtype, tol in API_TOL_REL.items():
        worst = {}

        def held(name, got, call):
            gots = got if isinstance(got, tuple) else (got,)
            wants = call(lambda t: t.cpu())
            wants = wants if isinstance(wants, tuple) else (wants,)
            for g, w in zip(gots, wants):
                rel = ((g.cpu().float() - w.float()).abs().max()
                       / w.float().abs().max()).item()
                worst[name] = max(worst.get(name, 0.0), rel)
                if not (g.dtype == dtype and g.device.type == dev_type
                        and bool(torch.isfinite(g).all())):
                    bad.append(f"{dtype} {name}: {g.dtype} {g.device}")

        end = chain(device, dtype, held)
        cpu_end = chain("cpu", dtype)
        bad += [f"{dtype} {n}: {r}" for n, r in worst.items() if not r <= tol]
        out[str(dtype)] = {
            "max_rel_diff_per_call": worst,
            "chain_end_max_abs_diff": (end.cpu().float()
                                       - cpu_end.float()).abs().max().item(),
            "chain_end_max_abs": cpu_end.float().abs().max().item()}
    out["seconds"] = time.time() - t_start
    emit(out)
    if bad:
        fail(f"api: off the CPU's results, device or dtype: {bad}")
    return out


# ---------------------------------------------------------------------------
# model and requests
# ---------------------------------------------------------------------------

def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.float(), b.float()
    return ((a - b).norm() / b.norm().clamp_min(1e-30)).item()


# the paths of the requests phase: bundle, conv_impl, latent of the batch-8
# model check (none: no model check), ControlNet, requests
PATHS = (
    # SDXL: the reference's largest size (2048x2048 px, 16 views in one
    # batch) through tiled_decoder=True; its decode phase at that size
    {"name": "sdxl", "sd_version": "XL1.0", "conv_impl": "kernel",
     "latent": 128, "decode": (256, 256), "graph_rows": (22, 16, 4, 2),
     "requests": ({"height": 1024, "width": 1536},
                  {"height": 1536, "width": 1536},
                  {"height": 2048, "width": 2048, "tiled_decoder": True})},
    # SD 1.5: its first request also runs cut after two steps with
    # checkpoint_every=2, then resumed from the file
    {"name": "sd15", "sd_version": "1.5", "conv_impl": "kernel", "latent": 64,
     "resume": True, "requests": ({"height": 512, "width": 768},)},
    # SD 2.1: the overlap-averaged tiles of a low_vram pipe at 768x768
    {"name": "sd21", "sd_version": "2.1", "conv_impl": "cudnn", "latent": 64,
     "decode": (96, 96), "graph_rows": (16, 2),
     "requests": ({"height": 512, "width": 768},
                  {"height": 768, "width": 768},
                  {"height": 768, "width": 768, "tiled_decoder": True,
                   "pipe": {"low_vram": True, "use_halo_decode": False}})},
    # ControlNet text2img: the condition of each request is a seeded image of
    # shapes on a background through the port's preprocessors. The SDXL
    # ControlNet gets its own batch-8 model check; the SD 1.5 one none (its
    # shapes are the SD 1.5 UNet's down path).
    {"name": "sdxl_canny", "sd_version": "XL1.0", "conv_impl": "kernel",
     "latent": 128, "controlnet": "canny", "graph_rows": (2,),
     "pair_rows": (16, 4, 2),
     "requests": ({"height": 1024, "width": 1536},)},
    {"name": "sd15_depth", "sd_version": "1.5", "conv_impl": "kernel",
     "controlnet": "depth", "requests": ({"height": 512, "width": 768},)},
    # --fp32 (fp32 weights and compute; every UNet attention and, with the
    # conv kernel, every gated conv on the three-pass TF32 bodies), run under
    # PyTorch's default TF32 flags: SD 1.5 through the CLI's main() with
    # --fp32 true (cuDNN convs, the CLI's default), SD 2.1 through
    # generate_image with conv_impl="kernel". Two steps, not the script's
    # four, to keep the whole script near 300 s (the shapes they launch do
    # not depend on the step count)
    {"name": "sd15_fp32", "sd_version": "1.5", "conv_impl": "cudnn",
     "latent": 64, "fp32": True, "entry": "cli", "steps": 2,
     "requests": ({"height": 512, "width": 768},)},
    {"name": "sd21_fp32", "sd_version": "2.1", "conv_impl": "kernel",
     "latent": 64, "fp32": True, "steps": 2, "graph_rows": (2,),
     "requests": ({"height": 512, "width": 768},)},
)


def path_runtime(path):
    """The RuntimeConfig a path's bundle loads with: the CLI's own for a
    path driven through the CLI, else bf16 or (fp32 paths) fp32 weights and
    compute with the path's conv_impl."""
    from elasticdiffusion_tpu_torch.configs import RuntimeConfig
    if path.get("entry") == "cli":
        from elasticdiffusion_tpu_torch.apps import cli
        rt = cli.runtime_config(cli.build_parser().parse_args(
            cli_argv(path, path["requests"][0], 1, 0, 0, "unused")))
        if rt.conv_impl != path["conv_impl"]:
            fail(f"{path['name']}: the CLI runs conv_impl={rt.conv_impl!r}")
        return rt
    if path.get("fp32"):
        return RuntimeConfig(conv_impl=path["conv_impl"],
                             param_dtype=torch.float32,
                             compute_dtype=torch.float32)
    return RuntimeConfig(conv_impl=path["conv_impl"])


def cli_argv(path, req, steps: int, resampling: int, seed: int,
             outdir: str) -> list:
    """The command line of one request of a path driven through the CLI."""
    return ["--sd_version", path["sd_version"], "--H", str(req["height"]),
            "--W", str(req["width"]), "--steps", str(steps),
            "--resampling_steps", str(resampling), "--seed", str(seed),
            "--fp32", "true" if path.get("fp32") else "false",
            "--outdir", outdir]


def run_cli(bundle, path, req, steps: int, resampling: int, seed: int):
    """One request through the CLI's main() as a user runs it. main() loads
    its bundle with load_bundle, which here hands it the path's bundle (the
    architecture and seed-0 random weights the CLI would load, biases and
    norm weights perturbed as on every path); the pipe main() makes records
    the final latent each decode starts from. Returns (image (1, 3, H, W) in
    [0, 1] from the saved PNG, info with the latent and the pipe's
    last_metrics, generator states)."""
    import contextlib
    import io
    import os
    import tempfile

    import numpy as np
    from PIL import Image

    from elasticdiffusion_tpu_torch.apps import cli
    from elasticdiffusion_tpu_torch.models import registry
    made, latents = [], []

    def path_bundle(sd_version, runtime=None, **kw):
        if sd_version != path["sd_version"] or runtime != bundle.runtime \
                or kw.get("checkpoint_dir") is not None:
            fail(f"{path['name']}: the CLI asked for another bundle: "
                 f"{sd_version} {runtime} {kw}")
        return bundle

    make_pipe = cli.make_pipe

    def recording_pipe(opt, *a, **k):
        pipe = make_pipe(opt, *a, **k)
        decode = pipe.decode_latents

        def recording_decode(lat):
            latents.append(lat.detach().float().cpu())
            return decode(lat)

        pipe.decode_latents = recording_decode
        made.append(pipe)
        return pipe

    load = registry.load_bundle
    registry.load_bundle, cli.make_pipe = path_bundle, recording_pipe
    try:
        with tempfile.TemporaryDirectory() as tmp, \
                record_generators() as rec, \
                contextlib.redirect_stdout(io.StringIO()):
            save_dir = cli.main(cli_argv(path, req, steps, resampling, seed,
                                         tmp))
            torch.cuda.synchronize()
            img = np.asarray(Image.open(os.path.join(save_dir, "0.png"))
                             .convert("RGB"))
    finally:
        registry.load_bundle, cli.make_pipe = load, make_pipe
    imgs = (img.astype(np.float32) / 255.0).transpose(2, 0, 1)[None]
    info = {"latent": torch.cat(latents).numpy(),
            "last_metrics": made[0].last_metrics}
    return imgs, info, rec.states()


def unet_inputs(bundle, n: int, gen: torch.Generator, rows: int = 8):
    """(latent, context, SDXL extras) of a forward of `rows` at n x n."""
    dt = bundle.runtime.compute_dtype
    ucfg = bundle.config.unet
    lat = torch.randn(rows, 4, n, n, generator=gen, device="cuda").to(dt)
    ctx = torch.randn(rows, 77, ucfg.cross_attention_dim, generator=gen,
                      device="cuda").to(dt)
    kw = {}
    if bundle.config.is_xl:
        kw = {"added_text_embeds": torch.randn(
                  rows, ucfg.pooled_projection_dim, generator=gen,
                  device="cuda"),
              "added_time_ids": torch.tensor(
                  [[4096.0, 6144.0, 0.0, 0.0, 4096.0, 6144.0]],
                  device="cuda").expand(rows, 6)}
    return lat, ctx, kw


def phase_model(bundle, path):
    """Kernels against plain versions inside the full-width models, and for
    a path that runs it, the conv kernel against cuDNN."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    lat, ctx, kw = unet_inputs(bundle, path["latent"], gen)
    z = torch.randn(1, 4, 64, 96, generator=gen, device="cuda")
    fp32 = bundle.runtime.compute_dtype == torch.float32
    out = {"phase": "model", "path": path["name"],
           "dtype": str(bundle.runtime.compute_dtype),
           "tolerance_rel_l2": E2E_FP32_TOL_REL_L2 if fp32 else 5e-2,
           "tolerance_why": E2E_FP32_WHY if fp32 else
           "bf16 activations through the whole network; the kernel and plain "
           "norms, and the conv kernel and cuDNN, round and sum at different "
           "places"}
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
    if fp32:
        # what the repair keeps out: the same forward with cuDNN's convs in
        # TF32 (the module called past the bundle, under the flag's default)
        prev = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = True
        try:
            tf32 = bundle.unet(lat, 501.0, ctx, **kw)
        finally:
            torch.backends.cudnn.allow_tf32 = prev
        out["unet_rel_l2_if_cudnn_ran_tf32"] = rel_l2(tf32, res["auto"][0])
        del tf32
    if path["conv_impl"] == "kernel" or fp32:
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


def phase_controlnet_model(bundle, path):
    """One batch-8 ControlNet + UNet forward at full width, every kernel
    (the path's conv_impl) against every plain version and cuDNN convs; the
    ControlNet's own time beside the UNet's."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    n, f = path["latent"], bundle.vae_scale_factor
    lat, ctx, kw = unet_inputs(bundle, n, gen)
    cond = torch.rand(8, 3, n * f, n * f, generator=gen, device="cuda")
    controlnet = lambda: bundle.apply_controlnet(lat, 501.0, ctx, cond, **kw)
    out = {"phase": "model", "path": path["name"], "tolerance_rel_l2": 5e-2,
           "tolerance_why": "bf16 activations through the ControlNet and the "
                            "UNet; kernels and plain versions round and sum "
                            "at different places"}
    res = {}
    for mode, conv in (("auto", path["conv_impl"]), ("off", "cudnn")):
        bundle.set_use_kernels(mode)
        bundle.set_conv_impl(conv)
        down, mid = controlnet()
        eps = bundle.apply_unet(lat, 501.0, ctx, down_block_residuals=down,
                                mid_block_residual=mid, **kw)
        res[mode] = (down[0], mid, eps)
        out[f"controlnet_ms_{mode}"] = time_ms(controlnet, 1, 5)
        out[f"unet_with_residuals_ms_{mode}"] = time_ms(
            lambda: bundle.apply_unet(lat, 501.0, ctx,
                                      down_block_residuals=down,
                                      mid_block_residual=mid, **kw), 1, 5)
        del down
    bundle.set_use_kernels("auto")
    bundle.set_conv_impl(path["conv_impl"])
    for i, name in enumerate(("down0_residual", "mid_residual",
                              "unet_with_residuals")):
        a, b = res["auto"][i], res["off"][i]
        if not torch.isfinite(a.float()).all():
            fail(f"{path['name']} {name}: output with kernels is not finite")
        out[f"{name}_shape"] = list(a.shape)
        out[f"{name}_rel_l2"] = rel_l2(a, b)
        out[f"{name}_rms"] = a.float().pow(2).mean().sqrt().item()
    emit(out)
    for name in ("down0_residual", "mid_residual", "unet_with_residuals"):
        if not out[f"{name}_rel_l2"] <= out["tolerance_rel_l2"]:
            fail(f"{path['name']} {name}: rel L2 {out[f'{name}_rel_l2']} over "
                 f"{out['tolerance_rel_l2']}")
        if not out[f"{name}_rms"] > 0:
            fail(f"{path['name']} {name}: zero output")


def profile_launches(fn) -> tuple:
    """(host launch calls, device ops, memsets by the innermost operator
    that issued them) of one call of `fn`, from torch.profiler's events;
    launches counted as ``portbench/spans.py`` counts them (kernels,
    graphs, copies, sets; a ``cu*`` call inside a ``cuda*`` call once)."""
    from torch.profiler import ProfilerActivity, profile

    from portbench import spans
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = list(prof.profiler.kineto_results.events())
    cuda = torch.autograd.DeviceType.CUDA
    ops = sum(1 for e in events
              if e.device_type() == cuda and not e.is_user_annotation())
    host = [e for e in events if e.device_type() != cuda]
    callers = sorted(((e.start_ns(), e.end_ns(), e.start_thread_id(),
                       e.name()) for e in host
                      if not e.name().startswith(("cu", "Memset", "Memcpy"))),
                     key=lambda c: c[0])
    memsets = collections.Counter()
    for e in host:
        if e.name().startswith("cudaMemsetAsync"):
            inner = [c for c in callers if c[0] <= e.start_ns()
                     and c[1] >= e.end_ns() and c[2] == e.start_thread_id()]
            memsets[inner[-1][3] if inner else "none"] += 1
    return len(spans.launches(events)), ops, dict(memsets.most_common(6))


def graph_pool_bytes() -> int:
    """Bytes the allocator holds in private pools (CUDA graphs')."""
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", (0, 0))) != (0, 0))


def phase_graphs(bundle, path):
    """The UNet forward through ``apply_unet``'s CUDA graphs at the path's
    keys, against the module's eager forward (see the module docstring)."""
    from elasticdiffusion_tpu_torch.models.convert import load_into
    from elasticdiffusion_tpu_torch.models.registry import _fp32_convs
    from elasticdiffusion_tpu_torch.models.unet_graphs import counted
    wrappers = kernels.wrappers()
    names = {w: n for n, w in wrappers.items()}
    used = ["flash_attention", "fused_layer_norm", "fused_group_norm"]
    if path["conv_impl"] == "kernel":
        used.append("conv3x3")
    graphs = bundle.unet_graphs
    graphs.drop()
    gen = torch.Generator(device="cuda").manual_seed(3)
    n, f = path["latent"], bundle.vae_scale_factor
    t0, t1 = 501.0, 261.0
    cases = {}
    for rows in path["graph_rows"]:
        lat, ctx, kw = unet_inputs(bundle, n, gen, rows)
        if bundle.controlnet is not None:
            cond = torch.rand(rows, 3, n * f, n * f, generator=gen,
                              device="cuda")
            down, mid = bundle.apply_controlnet(lat, t0, ctx, cond, **kw)
            kw = {**kw, "down_block_residuals": down,
                  "mid_block_residual": mid}
        cases[rows] = (lat, ctx, kw)

    def eager(rows, t=t0, inputs=None):
        lat, ctx, kw = inputs or cases[rows]
        with torch.no_grad(), _fp32_convs():
            return bundle.unet(lat, t, ctx, **kw)

    def graphed(rows, t=t0, inputs=None):
        lat, ctx, kw = inputs or cases[rows]
        return bundle.apply_unet(lat, t, ctx, **kw)

    mem0 = (torch.cuda.memory_allocated(), torch.cuda.memory_reserved())
    out = {"phase": "graphs", "path": path["name"],
           "dtype": str(bundle.runtime.compute_dtype),
           "controlnet": bundle.controlnet is not None, "keys": {}}
    worst = 0.0
    for rows in path["graph_rows"]:
        want = eager(rows)
        kinds, diffs = [], []
        for _ in range(3):
            got = graphed(rows)
            kinds.append(graphs.last)
            diffs.append((got.float() - want.float()).abs().max().item())
        if kinds != ["eager", "capture", "replay"]:
            fail(f"{path['name']} graphs {rows} rows: calls ran {kinds}")
        # another timestep: the fill of the static timestep
        diffs.append((graphed(rows, t1).float()
                      - eager(rows, t1).float()).abs().max().item())
        if graphs.last != "replay":
            fail(f"{path['name']} graphs {rows} rows: the second timestep "
                 f"ran {graphs.last}")
        worst = max(worst, *diffs)
        out["keys"][rows] = {"max_abs_diff": diffs,
                             "rms": want.float().pow(2).mean().sqrt().item()}
    # a replay counts the kernels an eager call of its key counts
    counts = {}
    for rows in path["graph_rows"]:
        _, e = counted(lambda: eager(rows))
        _, r = counted(lambda: graphed(rows))
        counts[rows] = {
            kind: {"counters": {f"{names[w]}.{c}": n
                                for (w, c), n in sorted(
                                    x.counters.items(),
                                    key=lambda i: (names[i[0][0]], i[0][1]))},
                   "log_entries": sum(x.log.values())}
            for kind, x in (("eager", e), ("replay", r))}
        counts[rows]["same"] = (e.counters == r.counters and e.log == r.log
                                and graphs.last == "replay")
    torch.cuda.synchronize()
    static = sum(t.numel() * t.element_size() for g in graphs.graphs.values()
                 for t in (*[x for x in g.inputs if x is not None], g.t, g.out))
    mem1 = (torch.cuda.memory_allocated(), torch.cuda.memory_reserved())
    out["memory"] = {"allocated_before": mem0[0], "allocated_after": mem1[0],
                     "reserved_before": mem0[1], "reserved_after": mem1[1],
                     "graph_pool_bytes": graph_pool_bytes(),
                     "static_bytes": static,
                     "allocated_over_static": mem1[0] - mem0[0] - static}
    for rows in path["graph_rows"]:
        e_launch, e_ops, e_sets = profile_launches(lambda: eager(rows))
        r_launch, r_ops, _ = profile_launches(lambda: graphed(rows))
        out["keys"][rows].update({
            "eager_launches": e_launch, "eager_device_ops": e_ops,
            "eager_memsets_by_op": e_sets,
            "replay_launches": r_launch, "replay_device_ops": r_ops,
            "eager_enqueue_ms": enqueue_ms(lambda: eager(rows)),
            "replay_enqueue_ms": enqueue_ms(lambda: graphed(rows)),
            "eager_ms": time_ms(lambda: eager(rows), 1, 5),
            "replay_ms": time_ms(lambda: graphed(rows), 1, 5)})
    # aliasing: every key replayed, then A, B, A on new inputs
    first = {rows: graphed(rows) for rows in path["graph_rows"]}
    kept = {rows: o.clone() for rows, o in first.items()}
    a, b = path["graph_rows"][0], path["graph_rows"][-1]
    fresh = {}
    for rows in (a, b):
        lat, ctx, kw = cases[rows]
        fresh[rows] = (lat.flip(0).contiguous(), ctx.flip(0).contiguous(), kw)
    alias = [(graphed(a, inputs=fresh[a]), eager(a, inputs=fresh[a])),
             (graphed(b, inputs=fresh[b]), eager(b, inputs=fresh[b])),
             (graphed(a), first[a])]
    changed = [rows for rows in first if not torch.equal(first[rows], kept[rows])]
    alias_diff = max((x.float() - y.float()).abs().max().item() for x, y in alias)
    out["aliasing"] = {"returned_tensors_changed": changed,
                       "max_abs_diff": alias_diff}
    # a reload in place: the replay reads the new weights where they lie
    old = {k: v.clone() for k, v in bundle.unet.state_dict().items()}
    load_into(bundle.unet, {k: v * 1.01 if v.is_floating_point() else v
                            for k, v in old.items()}, "scaled UNet")
    new_out = graphed(a)
    reload_kind = graphs.last
    reload_diff = (new_out.float() - eager(a).float()).abs().max().item()
    moved = (new_out.float() - first[a].float()).abs().max().item()
    load_into(bundle.unet, old, "UNet")
    del old
    back_diff = (graphed(a).float() - first[a].float()).abs().max().item()
    out["reload"] = {"ran": [reload_kind, graphs.last],
                     "max_abs_diff": reload_diff, "moved_by": moved,
                     "restored_max_abs_diff": back_diff}
    out["wrapper_counts"] = counts
    out["counts"] = {"replays": graphs.replays, "captures": graphs.captures,
                     "eager": graphs.eager}
    # the pool in either order of keys: the largest is captured first
    out["pool_by_order"] = {}
    for order in (sorted(path["graph_rows"]),
                  sorted(path["graph_rows"], reverse=True)):
        graphs.drop()
        c0 = graphs.captures
        for _ in range(3):
            for rows in order:
                graphed(rows)
        torch.cuda.synchronize()
        out["pool_by_order"][",".join(map(str, order))] = {
            "captures": graphs.captures - c0, "pool_bytes": graph_pool_bytes()}
    graphs.drop()
    emit(out)
    if changed:
        fail(f"{path['name']} graphs: a replay changed the tensors returned "
             f"for {changed} rows")
    for rows, c in counts.items():
        if not c["same"]:
            fail(f"{path['name']} graphs {rows} rows: a replay counted "
                 f"{c['replay']}, an eager call {c['eager']}")
        never = [k for k in used
                 if not c["eager"]["counters"].get(f"{k}.launches")]
        if never:
            fail(f"{path['name']} graphs {rows} rows: {never} launched "
                 f"nothing")
    if out["reload"]["ran"] != ["replay", "replay"] or not moved > 0:
        fail(f"{path['name']} graphs: the reload check ran "
             f"{out['reload']['ran']}, moved by {moved}")
    if not worst == 0.0 or not alias_diff == 0.0 or not reload_diff == 0.0 \
            or not back_diff == 0.0:
        fail(f"{path['name']} graphs: replay differs from the eager forward "
             f"by {max(worst, alias_diff, reload_diff, back_diff)}")


def phase_graph_pairs(bundle, path):
    """The ControlNet and the UNet as a pair of CUDA graphs
    (``apply_unet`` with a condition) at the canny cell's keys, against the
    modules' eager forwards (see the module docstring)."""
    from elasticdiffusion_tpu_torch.models.registry import _fp32_convs
    from elasticdiffusion_tpu_torch.models.unet_graphs import counted
    graphs = bundle.unet_graphs
    graphs.drop()
    gen = torch.Generator(device="cuda").manual_seed(5)
    n, f = path["latent"], bundle.vae_scale_factor
    dt = bundle.runtime.compute_dtype
    scale = 0.5
    cases = {}
    for rows in path["pair_rows"]:
        lat, ctx, kw = unet_inputs(bundle, n, gen, rows)
        # the direction's condition is one image broadcast, the views' not
        one = rows == max(path["pair_rows"])
        cond = torch.rand(1 if one else rows, 3, n * f, n * f, generator=gen,
                          device="cuda").to(dt)
        cases[rows] = (lat, ctx, kw, cond.expand(rows, *cond.shape[1:]))
    read = []
    hook = bundle.unet.register_forward_pre_hook(
        lambda m, a, k: read.append([r.data_ptr() for r in
                                     k.get("down_block_residuals") or []]),
        with_kwargs=True)

    def eager(rows, t=501.0, cond=None):
        lat, ctx, kw, c = cases[rows]
        with torch.no_grad(), _fp32_convs():
            down, mid = bundle.controlnet(lat, t, ctx, c if cond is None else cond,
                                          conditioning_scale=scale, **kw)
            return bundle.unet(lat, t, ctx, down_block_residuals=down,
                               mid_block_residual=mid, **kw)

    def paired(rows, t=501.0, cond=None):
        lat, ctx, kw, c = cases[rows]
        return bundle.apply_unet(lat, t, ctx, controlnet_cond=c if cond is None
                                 else cond, conditioning_scale=scale, **kw)

    out = {"phase": "graph_pairs", "path": path["name"], "keys": {}}
    worst, shared = 0.0, {}
    mem0 = torch.cuda.memory_allocated()
    try:
        for rows in path["pair_rows"]:
            want = eager(rows)
            kinds, diffs = [], []
            for _ in range(3):
                n0 = len(read)
                got = paired(rows)
                kinds.append(graphs.last)
                diffs.append((got.float() - want.float()).abs().max().item())
                if graphs.last == "capture":
                    key = next(k for k, g in graphs.graphs.items()
                               if g.cn is not None and g.cn.residuals[1].shape[0] == rows)
                    pair = graphs.graphs[key]
                    shared[rows] = read[n0:] == [[r.data_ptr() for r in
                                                   pair.cn.residuals[0]]]
            if kinds != ["eager", "capture", "replay"]:
                fail(f"{path['name']} pairs {rows} rows: calls ran {kinds}")
            other = cases[rows][3].flip(0).contiguous() * 0.5
            diffs.append((paired(rows, 261.0, other).float()
                          - eager(rows, 261.0, other).float()).abs().max().item())
            worst = max(worst, *diffs)
            _, e = counted(lambda: eager(rows))
            _, r = counted(lambda: paired(rows))
            lat = cases[rows][0]
            e_launch, e_ops, _ = profile_launches(lambda: eager(rows))
            r_launch, r_ops, _ = profile_launches(lambda: paired(rows))
            out["keys"][rows] = {
                "max_abs_diff": diffs, "residuals_shared": shared.get(rows),
                "static_cond_rows": pair.cn.cond.shape[0] if rows in shared else None,
                "counts_same": e.counters == r.counters and e.log == r.log,
                "eager_launches": e_launch, "replay_launches": r_launch,
                "eager_device_ops": e_ops, "replay_device_ops": r_ops,
                "eager_ms": time_ms(lambda: eager(rows), 1, 5),
                "replay_ms": time_ms(lambda: paired(rows), 1, 5),
                "controlnet_eager_ms": time_ms(lambda: bundle.apply_controlnet(
                    lat, 501.0, cases[rows][1], cases[rows][3],
                    conditioning_scale=scale, **cases[rows][2]), 1, 5)}
        torch.cuda.synchronize()
        for rows in path["pair_rows"]:
            pair = next(g for g in graphs.graphs.values()
                        if g.cn is not None and g.cn.residuals[1].shape[0] == rows)
            out["keys"][rows]["controlnet_replay_ms"] = time_ms(pair.cn.graph.replay, 1, 5)
        out["memory"] = {
            "allocated_over_before": torch.cuda.memory_allocated() - mem0,
            "static_cond_bytes": sum(g.cn.cond.numel() * g.cn.cond.element_size()
                                     for g in graphs.graphs.values() if g.cn),
            "graph_pool_bytes": graph_pool_bytes()}
        out["counts"] = {"replays": bundle.controlnet_graph_replays,
                         "captures": bundle.controlnet_graph_captures,
                         "eager": bundle.controlnet_graph_eager}
    finally:
        hook.remove()
        graphs.drop()
    emit(out)
    if not all(shared.get(rows) for rows in path["pair_rows"]):
        fail(f"{path['name']} pairs: the UNet graph did not read the "
             f"ControlNet graph's residuals: {shared}")
    if not all(k["counts_same"] for k in out["keys"].values()):
        fail(f"{path['name']} pairs: a replay counted other kernels than an "
             f"eager call")
    if not worst == 0.0:
        fail(f"{path['name']} pairs: replay differs from the eager forwards "
             f"by {worst}")


def replayed_residuals(bundle, key):
    """Whether the ControlNet graph of the pair at `key` ran at the call
    just made: the residuals it left in the pool against the ControlNet's
    eager forward on the static inputs the call loaded. A replay that did
    not run the ControlNet leaves an earlier call's residuals there, or
    whatever another graph wrote over them since. The eager forward is
    taken off the kernel wrappers' counters and the launch log.
    {"rel_l2", "max_abs", "rms"}."""
    from elasticdiffusion_tpu_torch.models.registry import _fp32_convs
    from elasticdiffusion_tpu_torch.models.unet_graphs import _counters
    g = bundle.unet_graphs.graphs[key]
    _, shape, _, _, scale = key[-1]
    latent, context, text, time_ids = g.inputs[:4]
    extras = {k: v for k, v in (("added_text_embeds", text),
                                ("added_time_ids", time_ids)) if v is not None}
    saved, log = _counters(), kernels.launch_log
    kernels.launch_log = None
    try:
        with torch.no_grad(), _fp32_convs():
            down, mid = bundle.controlnet(latent, g.t, context,
                                          g.cn.cond.expand(shape),
                                          conditioning_scale=scale, **extras)
    finally:
        for (w, name), n in saved.items():
            setattr(w, name, n)
        kernels.launch_log = log
    want = torch.cat([r.float().flatten() for r in (*down, mid)])
    got = torch.cat([r.float().flatten()
                     for r in (*g.cn.residuals[0], g.cn.residuals[1])])
    return {"rel_l2": ((got - want).norm() / want.norm()).item(),
            "max_abs": (got - want).abs().max().item(),
            "rms": want.pow(2).mean().sqrt().item()}


def check_replayed_pairs(bundle, out: dict):
    """After every ``bundle.apply_unet`` call that replayed a pair, before
    any other call can replay a graph over its pool memory, add
    ``replayed_residuals`` of its key to `out` under its rows. Returns the
    function that stops it."""
    from elasticdiffusion_tpu_torch.models.unet_graphs import graph_key
    apply = bundle.apply_unet

    def checked(latent, t, context, **kwargs):
        eps = apply(latent, t, context, **kwargs)
        if (kwargs.get("controlnet_cond") is not None
                and bundle.unet_graphs.last == "replay"):
            out.setdefault(int(latent.shape[0]), []).append(
                replayed_residuals(bundle, graph_key(latent, t, context,
                                                     **kwargs)))
        return eps

    bundle.apply_unet = checked
    return lambda: setattr(bundle, "apply_unet", apply)


def plain_cuda_counts():
    from elasticdiffusion_tpu_torch.kernels.attention import dot_product_attention
    from elasticdiffusion_tpu_torch.kernels.groupnorm import group_norm
    from elasticdiffusion_tpu_torch.kernels.layernorm import layer_norm
    return {"attention": dot_product_attention, "layer_norm": layer_norm,
            "group_norm": group_norm}


def check_cpu_rule(where: str, n: int) -> None:
    """``conv2d.cpu_calls`` counts the convolutions the port's CPU rule ran;
    a card path runs none."""
    if n:
        fail(f"{where}: {n} convolutions ran on the CPU on a card path")


def gate_convs(model):
    """The Conv3x3 modules of a UNet or ControlNet whose widths are inside
    the kernel's gate."""
    from elasticdiffusion_tpu_torch.kernels.conv3x3 import in_gate
    from elasticdiffusion_tpu_torch.models.layers import Conv3x3
    return [m for m in model.modules() if isinstance(m, Conv3x3)
            and in_gate((1, 8, 8, m.in_channels),
                        (3, 3, m.in_channels, m.out_channels))]


@torch.no_grad()
def perturb_modules(models, gen: torch.Generator) -> int:
    """Moves every bias and every norm weight of freshly loaded models off
    their seeded init (biases 0, norm weights 1) by 0.1 N(0, 1) from a
    seeded generator, so that a bias or a norm parameter wired to the wrong
    place changes the answer. Returns the number of tensors moved."""
    import torch.nn as nn
    moved = 0
    for model in models:
        for m in model.modules():
            params = [m.bias] if isinstance(getattr(m, "bias", None),
                                            nn.Parameter) else []
            if (isinstance(getattr(m, "weight", None), nn.Parameter)
                    and params and not isinstance(
                        m, (nn.Linear, nn.Conv2d, nn.ConvTranspose2d,
                            nn.Embedding))):
                params.append(m.weight)  # a norm (seeded_init_'s rule)
            for p in params:
                p.add_((0.1 * torch.randn(p.shape, generator=gen,
                                          device=p.device)).to(p.dtype))
                moved += 1
    return moved


@torch.no_grad()
def perturb_bundle(bundle, seed: int) -> int:
    """`perturb_modules` on every model of a bundle, the ControlNet too. The
    compute-dtype VAE copy takes the fp32 VAE's new values."""
    gen = torch.Generator(device=bundle.device).manual_seed(seed)
    models = [bundle.unet, bundle.vae_fp32, *bundle.text_models]
    if bundle.controlnet is not None:
        models.append(bundle.controlnet)
    moved = perturb_modules(models, gen)
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
               "an NVIDIA H100 80GB HBM3 at 700 W measured 0.026-0.035 on "
               "the three text2img paths and 0.028-0.029 on the two "
               "ControlNet paths, and one batch-8 forward differs by "
               "0.013-0.018 (the model phase's bar is 5e-2 too)")


# The fp32 paths' bar, for the end-to-end check and the model phase alike:
# the kernels and the plain versions both compute in fp32, so the bar sits
# between what sound fp32 gives and what one TF32 fault gives.
E2E_FP32_TOL_REL_L2 = 1e-4
E2E_FP32_WHY = ("fp32 through every UNet forward and the decode: the "
                "kernels (attention and conv3x3 in three TF32 passes) and the "
                "plain versions sum in other orders; the first runs on an "
                "NVIDIA H100 80GB HBM3 at 700 W measured 8.3e-6 and 9.3e-6 "
                "end to end and 3.0e-6-3.9e-6 for one batch-8 forward, while "
                "the same forward with cuDNN's convs in TF32 moved 1.1e-3-"
                "1.2e-3: the bar lies between, so it fails on TF32 convs")


def e2e_tolerance(path) -> tuple:
    """(rel L2 bar, why) of a path's kernels-against-plain checks."""
    if path.get("fp32"):
        return E2E_FP32_TOL_REL_L2, E2E_FP32_WHY
    return E2E_TOL_REL_L2, E2E_TOL_WHY


def scene(height: int, width: int, seed: int):
    """A seeded RGB image of flat shapes on a background, uint8: edges for
    canny and regions for the depth model."""
    import numpy as np
    rng = np.random.default_rng(seed)
    img = np.empty((height, width, 3), np.uint8)
    img[:] = rng.integers(0, 256, 3)
    yy, xx = np.mgrid[:height, :width]
    for _ in range(12):
        cy, cx = rng.integers(0, height), rng.integers(0, width)
        ry, rx = rng.integers(height // 16, height // 4, 2)
        if rng.random() < 0.5:  # an ellipse
            inside = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1.0
        else:                   # a rectangle
            inside = (abs(yy - cy) <= ry) & (abs(xx - cx) <= rx)
        img[inside] = rng.integers(0, 256, 3)
    return img


def smoke_dpt(seed: int):
    """A DPT-large on the card with seeded random weights, its biases and
    norm weights perturbed, and its last conv's weights non-negative (see
    condition_images)."""
    from elasticdiffusion_tpu_torch.models.dpt import DPT_LARGE, random_dpt
    gen = torch.Generator(device="cuda").manual_seed(seed)
    dpt = random_dpt(DPT_LARGE, gen, device="cuda")
    perturb_modules([dpt], gen)
    with torch.no_grad():
        dpt.head.head[4].weight.abs_()
    return dpt


def condition_images(path, seed: int) -> list:
    """The ControlNet condition of each request of a path, as a user makes
    it: a scene through the port's process_condition_image (canny, or depth
    from a DPT-large with seeded random weights, its biases and norm weights
    perturbed) and prepare_image; (1, 3, H, W) in [0, 1].

    With random weights the sign of the depth head's last 1x1 conv, summed
    over 32 non-negative (ReLU) inputs with a large common part, is one coin
    flip for the whole image, and its ReLU then gives a constant depth map
    half of the time (the JAX package's DPT test shifts the head's biases
    for the same reason). Its weights are made non-negative, so the depth
    map varies with the scene."""
    from elasticdiffusion_tpu_torch.apps.preprocessors import (
        prepare_image, process_condition_image)
    depth_fn = None
    if path["controlnet"] == "depth":
        from elasticdiffusion_tpu_torch.models.dpt import make_depth_fn
        depth_fn = make_depth_fn(smoke_dpt(seed + 7))
    out = []
    for i, req in enumerate(path["requests"]):
        h, w = req["height"], req["width"]
        pil = process_condition_image(scene(h, w, seed + i),
                                      path["controlnet"], depth_fn)
        out.append(prepare_image(pil, w, h))
    return out


def generate(pipe, path, req, steps: int, resampling: int, seed: int,
             condition=None, **extra):
    """One request of a path from a seed; (images, info, generator states).
    `extra` goes to generate_image (checkpoint and resume arguments)."""
    if path.get("entry") == "cli":
        return run_cli(pipe.bundle, path, req, steps, resampling, seed)
    pipe.seed_everything(seed)
    if condition is not None:
        extra["condition_image"] = condition
    kw = {k: v for k, v in req.items() if k != "pipe"}
    with record_generators() as rec:
        imgs, info = pipe.generate_image(
            "a photo of a lighthouse on a cliff at dusk", negative_prompts="",
            num_inference_steps=steps, resampling_steps=resampling,
            repaint_sampling=True, return_arrays=True, **kw, **extra)
    torch.cuda.synchronize()
    return imgs, info, rec.states()


def request_pipe(pipe, req):
    """The pipe a request runs on: the path's, or for a request with
    "pipe" options (low_vram, use_halo_decode) one built with them on the
    same bundle."""
    opts = req.get("pipe")
    if not opts:
        return pipe
    from elasticdiffusion_tpu_torch.core.pipeline import ElasticDiffusion
    other = ElasticDiffusion(device="cuda", bundle=pipe.bundle,
                             low_vram=opts.get("low_vram", False))
    other.use_halo_decode = opts.get("use_halo_decode", True)
    return other


# A replayed pair's ControlNet graph's residuals against the ControlNet's
# eager forward on the same static inputs: a replay computes them to the
# bit (the graphs phase); residuals left from an earlier call of the key,
# at another step's latent and timestep, lie far outside
PAIR_RESIDUAL_REL_L2 = 1e-3

# A run resumed from a latent checkpoint against the same run uninterrupted:
# the same kernels on the same inputs in the same order
RESUME_TOL_REL_L2 = 1e-6


def resume_check(pipe, path, steps: int, resampling: int, first) -> dict:
    """The path's first request again with checkpoint_every=2, cut after
    its second step (a progress wrapper ends the loop there, as an
    interrupted run would), then resumed from its checkpoint file: its final
    latent against the uninterrupted run's (`first`)."""
    import itertools
    import tempfile

    import numpy as np
    req = path["requests"][0]
    with tempfile.TemporaryDirectory() as tmp:
        ck = f"{tmp}/latent.npz"
        generate(pipe, path, req, steps, resampling, 0, checkpoint_path=ck,
                 checkpoint_every=2,
                 progress=lambda it: itertools.islice(it, 2))
        saved_step = int(np.load(ck)["step"])
        _, info, _ = generate(pipe, path, req, steps, resampling, 0,
                              resume_from=ck)
    a = torch.as_tensor(info["latent"]).float()
    b = torch.as_tensor(first["latent"]).float()
    return {"request": req, "checkpoint_every": 2, "saved_step": saved_step,
            "rel_l2": rel_l2(a, b), "bitwise_equal": bool(torch.equal(a, b)),
            "tolerance_rel_l2": RESUME_TOL_REL_L2}


def end_to_end(pipe, path, steps: int, resampling: int, kernel_run,
               condition=None) -> dict:
    """The path's smallest request again with every kernel off, against
    `kernel_run` = (info, generator states) of the same request and seed
    with the kernels."""
    bundle = pipe.bundle
    bundle.set_use_kernels("off")
    bundle.set_conv_impl("cudnn")
    try:
        _, info, states = generate(pipe, path, path["requests"][0], steps,
                                   resampling, 0, condition)
    finally:
        bundle.set_use_kernels("auto")
        bundle.set_conv_impl(path["conv_impl"])
    k_info, k_states = kernel_run
    same_draws = len(states) == len(k_states) and all(
        torch.equal(a, b) for a, b in zip(states, k_states))
    a = torch.as_tensor(k_info["latent"]).float()
    b = torch.as_tensor(info["latent"]).float()
    tol, why = e2e_tolerance(path)
    return {"request": path["requests"][0], "latent_shape": list(a.shape),
            "rel_l2": rel_l2(a, b), "max_abs": (a - b).abs().max().item(),
            "finite": bool(torch.isfinite(a).all() and torch.isfinite(b).all()),
            "tolerance_rel_l2": tol, "tolerance_why": why,
            "generators": len(states), "same_random_draws": same_draws}


def phase_requests(pipe, path, steps: int, resampling: int, checked=None):
    """One main path. Every launch count is set to 0 just before and read
    just after; comparison launches of the other phases do not count.
    `checked` is the set of launch-log keys the kernels phase held against a
    plain version (None when that phase did not run): a shape launched here
    and checked nowhere fails the run. After the counts are read, the first
    request runs again with the plain versions (`end_to_end`)."""
    wrappers, plain = kernels.wrappers(), plain_cuda_counts()
    conv_on = path["conv_impl"] == "kernel"
    bundle = pipe.bundle
    controlnet = bundle.controlnet
    conditions = [None] * len(path["requests"])
    condition_seconds = None
    if controlnet is not None:
        t0 = time.time()
        conditions = condition_images(path, 100)
        torch.cuda.synchronize()
        condition_seconds = time.time() - t0
    unet_convs = gate_convs(bundle.unet)
    cn_convs = [] if controlnet is None else gate_convs(controlnet)
    convs = unet_convs + cn_convs
    for w in wrappers.values():
        w.launches = 0
    wrappers["conv3x3"].copies = 0
    wrappers["fused_group_norm"].copies = 0
    for d in plain.values():
        d.plain_cuda_calls = 0
    for m in convs:
        m.library_cuda_calls = 0
    conv2d.cpu_calls = 0
    calls = collections.Counter()
    residual_rms = {}

    def controlnet_calls():
        # a call replayed from a CUDA graph runs no module hook: the
        # bundle counts the ControlNet's calls of every kind
        return (bundle.controlnet_graph_replays
                + bundle.controlnet_graph_captures
                + bundle.controlnet_graph_eager)

    def first_residuals(module, inputs, out):
        # the ControlNet's first call of the path: the first step's direction
        if not residual_rms:
            down, mid = out
            for name, r in (("mid", mid), ("down0", down[0])):
                residual_rms[name] = r.float().pow(2).mean().sqrt().item()

    # cuDNN's TF32 flag as the UNet and ControlNet forwards read it
    tf32_read = []

    def read_tf32(module, args):
        tf32_read.append(torch.backends.cudnn.allow_tf32)

    hooks = [bundle.unet.register_forward_pre_hook(read_tf32)]
    if controlnet is not None:
        hooks += [controlnet.register_forward_hook(first_residuals),
                  controlnet.register_forward_pre_hook(read_tf32)]
    kernels.launch_log = collections.Counter()
    # the UNet calls the pipeline made: a call replayed from a CUDA graph
    # runs no module forward and no hook, and counts here
    graphs = bundle.unet_graphs
    applied, graphs0 = [], (graphs.replays, graphs.captures)
    unrecord = record_unet_rows(bundle, applied)
    calls0 = controlnet_calls()
    # by rows: each replayed pair's ControlNet graph against its eager forward
    replayed = {}
    uncheck = check_replayed_pairs(bundle, replayed) \
        if controlnet is not None else None

    answers, first = [], None
    for i, req in enumerate(path["requests"]):
        before = {n: w.launches for n, w in wrappers.items()}
        rpipe = request_pipe(pipe, req)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        imgs, info, states = generate(rpipe, path, req, steps, resampling, i,
                                      conditions[i])
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
                        "last_metrics": info.get("last_metrics",
                                                 rpipe.last_metrics)})
        if req.get("tiled_decoder") and not rpipe.use_halo_decode:
            # the overlap average is an approximation: reported, not gated
            mono = rpipe.decode_latents(torch.as_tensor(info["latent"],
                                                        device="cuda"))
            answers[-1]["tiled_vs_monolithic_mean_abs"] = (
                mono.cpu() - torch.as_tensor(imgs)).abs().mean().item()
            del mono
        del rpipe
        if not ok_shape:
            fail(f"{path['name']} {req}: image shape {tuple(imgs.shape)}")
        if not finite or lo < 0.0 or hi > 1.0:
            fail(f"{path['name']} {req}: image not finite or outside [0, 1]")
        if not hi > lo:
            fail(f"{path['name']} {req}: image is constant")
        never = [n for n, c in launched.items()
                 if c == 0 and (conv_on or n != "conv3x3")
                 and not n.startswith("group_norm_")]
        if never:
            fail(f"{path['name']} {req}: never launched: {never}")
    resume = resume_check(pipe, path, steps, resampling, first[0]) \
        if path.get("resume") else None
    for h in hooks:
        h.remove()
    if uncheck is not None:
        uncheck()
    unrecord()
    calls["controlnet"] = controlnet_calls() - calls0
    graphed = {"apply_unet_calls": len(applied),
               "replays": graphs.replays - graphs0[0],
               "captures": graphs.captures - graphs0[1]}
    log = kernels.launch_log
    kernels.launch_log = None
    plain_calls = {n: d.plain_cuda_calls for n, d in plain.items()}
    totals = {n: w.launches for n, w in wrappers.items()}
    cudnn_in_gate = sum(m.library_cuda_calls for m in convs)
    gn_copies = wrappers["fused_group_norm"].copies
    e2e = end_to_end(pipe, path, steps, resampling, first, conditions[0])
    cpu_calls = conv2d.cpu_calls  # the end-to-end rerun too
    expected_conv = (len(unet_convs) * len(applied)
                     + len(cn_convs) * calls["controlnet"]) if conv_on else 0
    unchecked = {} if checked is None else {
        "/".join(map(str, key)): n for key, n in sorted(log.items(), key=str)
        if key not in checked}
    emit({"phase": "requests", "path": path["name"],
          "sd_version": path["sd_version"], "conv_impl": path["conv_impl"],
          "steps": steps, "resampling_steps": resampling,
          "answers": answers, "plain_versions_on_cuda": plain_calls,
          "launches": totals, "unet_calls": len(applied),
          "unet_graphs": graphed,
          "gate_convs_per_unet_call": len(unet_convs),
          "controlnet": path.get("controlnet"),
          "controlnet_calls": calls["controlnet"],
          "gate_convs_per_controlnet_call": len(cn_convs),
          "controlnet_residual_rms_first_step": residual_rms,
          "controlnet_replays_checked": {
              rows: {"calls": len(r), "max_rel_l2": max(v["rel_l2"] for v in r),
                     "min_rms": min(v["rms"] for v in r)}
              for rows, r in replayed.items()},
          "condition_seconds": condition_seconds,
          "condition_std": [None if c is None else float(c.std())
                            for c in conditions],
          "conv3x3_expected_launches": expected_conv,
          "conv3x3_operand_copies": wrappers["conv3x3"].copies,
          "cudnn_calls_in_gate": cudnn_in_gate,
          "group_norm_operand_copies": gn_copies,
          "cpu_conv_calls": cpu_calls,
          "entry": path.get("entry", "generate_image"),
          "compute_dtype": str(bundle.runtime.compute_dtype),
          "cudnn_allow_tf32_outside": torch.backends.cudnn.allow_tf32,
          "cudnn_allow_tf32_in_forwards": sorted(set(tf32_read)),
          "unchecked_launches": unchecked, "end_to_end": e2e,
          "resume": resume})
    if path.get("fp32") and (True in tf32_read or not tf32_read):
        fail(f"{path['name']}: an fp32 forward ran with cuDNN's TF32 on "
             f"(read {sorted(set(tf32_read))})")
    if unchecked:
        fail(f"{path['name']}: kernels launched at shapes that no kernel case "
             f"checks: {sorted(unchecked)}")
    if any(plain_calls.values()):
        fail(f"a plain version stood in for a kernel on the GPU: {plain_calls}")
    check_cpu_rule(path["name"], cpu_calls)
    if resume is not None and not resume["rel_l2"] <= RESUME_TOL_REL_L2:
        fail(f"{path['name']}: the resumed run's final latent differs from "
             f"the uninterrupted run's: {resume}")
    if not (e2e["finite"] and e2e["same_random_draws"]
            and e2e["rel_l2"] <= e2e["tolerance_rel_l2"]):
        fail(f"{path['name']}: kernels against plain versions end to end: "
             f"{e2e}")
    if conv_on and cudnn_in_gate:
        fail(f"{path['name']}: the library conv ran {cudnn_in_gate} times "
             f"inside the conv kernel's gate under conv_impl='kernel'")
    if totals["conv3x3"] != expected_conv:
        fail(f"{path['name']}: conv3x3 launched {totals['conv3x3']} times, the "
             f"code gives {len(unet_convs)} x {len(applied)} + "
             f"{len(cn_convs)} x {calls['controlnet']} = {expected_conv}")
    if controlnet is not None:
        if calls["controlnet"] != len(applied):
            fail(f"{path['name']}: {calls['controlnet']} ControlNet calls for "
                 f"{len(applied)} UNet calls")
        stale = {rows: r for rows, r in replayed.items()
                 if not all(v["rel_l2"] <= PAIR_RESIDUAL_REL_L2 and v["rms"] > 0
                            for v in r)}
        if not replayed or stale:
            fail(f"{path['name']}: a replayed pair's ControlNet graph did not "
                 f"leave the residuals of the call (none replayed: "
                 f"{not replayed}): {stale}")
        if not (len(residual_rms) == 2
                and all(v > 0 for v in residual_rms.values())):
            fail(f"{path['name']}: the ControlNet's residuals are zero at the "
                 f"first step: {residual_rms}")
        if not all(float(c.std()) > 0 for c in conditions):
            fail(f"{path['name']}: a condition image is constant")
    return log, totals


# The streamed and halo routes against decode_latents on the same latent:
# fp32 (SDXL, TF32 off) differs only in the order of sums; bf16 (SD 2.1)
# rounds the windows' normalised activations and conv outputs to bf16 at
# other places than the monolithic modules do
DECODE_TOL_REL_L2 = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
# The band route of the decode phase: halo_decode(num_bands=DECODE_BANDS) at
# the module's DEFAULT_HALO. It is approximate by design (each band takes
# its own GroupNorm moments), so it is held to the same route on the plain
# versions within DECODE_TOL_REL_L2, and its distance from decode_latents is
# recorded, not bounded
DECODE_BANDS = 4


def event_ms(fn):
    """(result, seconds on the host clock to the end of a synchronise,
    milliseconds between CUDA events around the call)."""
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.time()
    a.record()
    out = fn()
    b.record()
    torch.cuda.synchronize()
    return out, time.time() - t0, a.elapsed_time(b)


def phase_decode(bundle, path, checked=None, chunk_budgets=()):
    """One latent of the path's "decode" size through four routes:
    decode_latents (the modules), halo_decode(streamed=False),
    halo_decode(streamed=True) and halo_decode(num_bands=DECODE_BANDS); per
    route seconds, CUDA-event ms and peak bytes (each route runs once before
    it is measured), its rel L2 against decode_latents, and the branch
    halo_decode's default choice takes at that size. Launch counts are set
    to 0 just before and read just after, as for a path of the requests
    phase. After the counts are read, the band route runs again on the
    plain versions (`rel_l2_plain`), and `chunk_budgets`: the streamed
    route again at each slab budget (bytes)."""
    from elasticdiffusion_tpu_torch.parallel import halo_decode as hd
    h, w = path["decode"]
    vsf = bundle.vae_scale_factor
    gen = torch.Generator(device="cuda").manual_seed(3)
    # a latent at the scale of a denoised one, already / scaling_factor
    z = torch.randn(1, 4, h, w, generator=gen, device="cuda") * 5.0
    dtype = torch.float32 if bundle.fp32_decode else bundle.vae.dtype
    routes = {"decode_latents": lambda: bundle.vae_decode(z),
              "halo_monolithic": lambda: hd.halo_decode(bundle, z,
                                                        streamed=False),
              "halo_streamed": lambda: hd.halo_decode(bundle, z,
                                                      streamed=True),
              "halo_bands": lambda: hd.halo_decode(bundle, z,
                                                   num_bands=DECODE_BANDS)}
    wrappers, plain = kernels.wrappers(), plain_cuda_counts()
    for wr in wrappers.values():
        wr.launches = 0
    wrappers["fused_group_norm"].copies = 0
    for d in plain.values():
        d.plain_cuda_calls = 0
    conv2d.cpu_calls = 0
    kernels.launch_log = collections.Counter()
    out, ref = {}, None
    for name, fn in routes.items():
        fn()  # cuDNN's and the allocator's first-call set-up
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        img, sec, ms = event_ms(fn)
        peak = torch.cuda.max_memory_allocated()
        if not torch.isfinite(img.float()).all():
            fail(f"{path['name']} decode {name}: not finite")
        if ref is None:
            ref = img
        out[name] = {"seconds": sec, "event_ms": ms, "peak_bytes": peak,
                     "peak_above_resident": peak - resident,
                     "peak_above_resident_per_px":
                         (peak - resident) / (h * vsf * w * vsf),
                     "rel_l2": rel_l2(img, ref),
                     "max_abs": (img.float() - ref.float()).abs().max().item(),
                     "shape": list(img.shape)}
        if name == "halo_bands":
            bands = img
        del img
    log = kernels.launch_log
    kernels.launch_log = None
    totals = {n: wr.launches for n, wr in wrappers.items()}
    plain_calls = {n: d.plain_cuda_calls for n, d in plain.items()}
    bundle.set_use_kernels("off")
    try:
        plain_bands = routes["halo_bands"]()
    finally:
        bundle.set_use_kernels("auto")
    out["halo_bands"]["rel_l2_plain"] = rel_l2(bands, plain_bands)
    out["halo_bands"]["max_abs_plain"] = (
        bands.float() - plain_bands.float()).abs().max().item()
    del bands, plain_bands
    sweep, default_chunk = {}, hd.CHUNK_BYTES
    for budget in chunk_budgets:
        hd.CHUNK_BYTES = budget
        try:
            hd.halo_decode(bundle, z, streamed=True)
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            resident = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            img, sec, ms = event_ms(lambda: hd.halo_decode(bundle, z,
                                                           streamed=True))
        finally:
            hd.CHUNK_BYTES = default_chunk
        sweep[str(budget)] = {
            "seconds": sec, "event_ms": ms,
            "peak_above_resident": torch.cuda.max_memory_allocated() - resident,
            "rel_l2": rel_l2(img, ref)}
        del img
    unchecked = {} if checked is None else {
        "/".join(map(str, key)): n for key, n in sorted(log.items(), key=str)
        if key not in checked}
    cpu_calls = conv2d.cpu_calls  # the plain and sweep runs too
    tol = DECODE_TOL_REL_L2[dtype]
    emit({"phase": "decode", "path": path["name"],
          "sd_version": path["sd_version"], "latent": [h, w],
          "pixels": h * vsf * w * vsf, "dtype": str(dtype), "routes": out,
          "default_branch": hd.choose_branch(dtype, 1, h, w, vsf),
          "bands": DECODE_BANDS, "halo": hd.DEFAULT_HALO,
          "max_px": hd.MAX_PX[dtype], "chunk_bytes": hd.CHUNK_BYTES,
          "chunk_sweep": sweep, "tolerance_rel_l2": tol, "launches": totals,
          "plain_versions_on_cuda": plain_calls,
          "group_norm_operand_copies": wrappers["fused_group_norm"].copies,
          "cpu_conv_calls": cpu_calls,
          "unchecked_launches": unchecked})
    del ref, z
    torch.cuda.empty_cache()
    if unchecked:
        fail(f"{path['name']} decode: kernels launched at shapes that no "
             f"kernel case checks: {sorted(unchecked)}")
    if any(plain_calls.values()):
        fail(f"a plain version stood in for a kernel on the GPU: {plain_calls}")
    check_cpu_rule(f"{path['name']} decode", cpu_calls)
    never = [n for n in ("flash_attention", "fused_group_norm",
                         "group_norm_sums", "group_norm_apply")
             if totals[n] == 0]
    if never:
        fail(f"{path['name']} decode: never launched: {never}")
    for name in ("halo_monolithic", "halo_streamed"):
        if not out[name]["rel_l2"] <= tol:
            fail(f"{path['name']} decode {name}: rel L2 {out[name]['rel_l2']} "
                 f"against decode_latents, over {tol}")
    if not out["halo_bands"]["rel_l2_plain"] <= tol:
        fail(f"{path['name']} decode halo_bands: rel L2 "
             f"{out['halo_bands']['rel_l2_plain']} against the same route on "
             f"the plain versions, over {tol}")
    return log, totals


# The bundle the apps phase writes to disk and reads back: SD 1.5 with the
# depth ControlNet, perturbed, at full width
APPS_PATH = "sd15_depth"
# the CLI requests (height, width) px; the PCA app's: 512x512 px, an image
# logged every PCA_LOG_FREQ steps
APPS_SIZE, PCA_SIZE, PCA_LOG_FREQ = (512, 768), 512, 2


def save_dpt(dpt, out_dir: str) -> int:
    """A DPT as a transformers DPTForDepthEstimation directory
    (config.json, model.safetensors), with the two modules transformers
    holds and a depth forward never runs (the backbone's last LayerNorm,
    the first fusion layer's residual_layer1) filled from a seeded
    generator. Returns the bytes written."""
    import json
    import os

    from safetensors.torch import save_file
    c = dpt.config
    D, fh = c.hidden_size, c.fusion_hidden_size
    gen = torch.Generator().manual_seed(0)
    sd = {k: v.detach().cpu().contiguous() for k, v in dpt.state_dict().items()}
    sd["dpt.layernorm.weight"] = torch.ones(D)
    sd["dpt.layernorm.bias"] = torch.zeros(D)
    for i in (1, 2):
        pre = f"neck.fusion_stage.layers.0.residual_layer1.convolution{i}"
        sd[pre + ".weight"] = torch.randn(fh, fh, 3, 3, generator=gen) * 0.02
        sd[pre + ".bias"] = torch.zeros(fh)
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "model.safetensors")
    save_file(sd, path)
    config = {"architectures": ["DPTForDepthEstimation"], "model_type": "dpt",
              "hidden_size": D, "num_hidden_layers": c.num_layers,
              "num_attention_heads": c.num_heads,
              "intermediate_size": c.intermediate_size,
              "patch_size": c.patch_size, "image_size": c.image_size,
              "backbone_out_indices": list(c.backbone_out_indices),
              "neck_hidden_sizes": list(c.neck_hidden_sizes),
              "reassemble_factors": list(c.reassemble_factors),
              "fusion_hidden_size": fh, "layer_norm_eps": c.layer_norm_eps,
              "is_hybrid": False, "readout_type": "project"}
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump(config, f)
    return os.path.getsize(path) + os.path.getsize(
        os.path.join(out_dir, "config.json"))


def differing_tensors(pairs) -> tuple:
    """(tensors compared, names of those not equal in dtype and value) over
    (name, module, module) pairs, parameters and buffers."""
    n, differ = 0, []
    for name, a, b in pairs:
        sa, sb = a.state_dict(), b.state_dict()
        if sa.keys() != sb.keys():
            differ.append(f"{name}: other keys")
            continue
        for k, t in sa.items():
            n += 1
            if t.dtype != sb[k].dtype or not torch.equal(t, sb[k]):
                differ.append(f"{name}.{k}")
    return n, differ


def bundle_pairs(a, b):
    pairs = [("unet", a.unet, b.unet), ("vae_fp32", a.vae_fp32, b.vae_fp32),
             ("vae", a.vae, b.vae),
             ("controlnet", a.controlnet, b.controlnet)]
    return pairs + [(f"text_encoder_{i}", x, y)
                    for i, (x, y) in enumerate(zip(a.text_models,
                                                   b.text_models))]


def phase_apps(bundle, path, checked=None, steps: int = 4,
               resampling: int = 3):
    """The apps at full width from a checkpoint on disk. The path's bundle
    (SD 1.5 + the depth ControlNet, perturbed) is written as a diffusers
    directory and the smoke's DPT-large as a transformers one, and read back
    with load_bundle(checkpoint_dir=...), every tensor equal. Then, each
    through its main() as a user runs it: the CLI (512x768), the ControlNet
    CLI (depth through ED_DPT_DIR, a scene as the condition image) and the
    PCA app (512x512). Launch counts are set to 0 just before the first app
    and read just after the last; `unchecked_launches` as for a path. Then
    the two CLI requests run again on the source bundle through
    ElasticDiffusion, with the runtime the CLI builds (cuDNN convs), and
    the saved PNGs must equal them in every uint8 value."""
    import contextlib
    import io
    import os
    import tempfile

    import numpy as np
    from PIL import Image

    from elasticdiffusion_tpu_torch.apps import (cli, cli_controlnet,
                                                 pca_scores, preprocessors)
    from elasticdiffusion_tpu_torch.core.pipeline import ElasticDiffusion
    from elasticdiffusion_tpu_torch.models.controlnet import ControlNet
    from elasticdiffusion_tpu_torch.models.convert import save_bundle
    from elasticdiffusion_tpu_torch.models.dpt import make_depth_fn
    from elasticdiffusion_tpu_torch.models.registry import load_bundle
    out = {"phase": "apps", "path": path["name"],
           "sd_version": path["sd_version"], "controlnet": path["controlnet"]}
    dpt = smoke_dpt(107)  # condition_images' DPT of this path
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "sd15")
        dpt_dir = os.path.join(tmp, "dpt-large")
        torch.cuda.synchronize()
        t0 = time.time()
        nbytes = save_bundle(bundle, ckpt)
        t1 = time.time()
        dpt_bytes = save_dpt(dpt, dpt_dir)
        t2 = time.time()
        loaded = load_bundle(path["sd_version"], runtime=bundle.runtime,
                             checkpoint_dir=ckpt,
                             controlnet_model=path["controlnet"])
        torch.cuda.synchronize()
        t3 = time.time()
        n, differ = differing_tensors(bundle_pairs(bundle, loaded))
        del loaded
        gc.collect()
        torch.cuda.empty_cache()
        out["checkpoint"] = {
            "bytes": nbytes, "files": sorted(os.listdir(ckpt)),
            "write_seconds": t1 - t0, "dpt_bytes": dpt_bytes,
            "dpt_write_seconds": t2 - t1, "load_seconds": t3 - t2,
            "tensors_compared": n, "tensors_differing": differ[:20]}
        if differ or not n:
            emit(out)
            fail(f"apps: the bundle read back from {ckpt} differs: {differ[:20]}")

        scene_png = os.path.join(tmp, "scene.png")
        Image.fromarray(scene(*APPS_SIZE, 300)).save(scene_png)
        common = ["--sd_version", path["sd_version"], "--checkpoint_dir", ckpt,
                  "--seed", "0", "--steps", str(steps)]
        t2i = common + ["--H", str(APPS_SIZE[0]), "--W", str(APPS_SIZE[1]),
                        "--resampling_steps", str(resampling)]
        argvs = {"cli": t2i + ["--outdir", os.path.join(tmp, "cli")],
                 "cli_controlnet": t2i + [
                     "--outdir", os.path.join(tmp, "cli_controlnet"),
                     "--controlnet_model", path["controlnet"],
                     "--condition_image", scene_png],
                 "pca_scores": common + [
                     "--H", str(PCA_SIZE), "--W", str(PCA_SIZE),
                     "--log_freq", str(PCA_LOG_FREQ),
                     "--outdir", os.path.join(tmp, "pca")]}
        mains = {"cli": cli.main, "cli_controlnet": cli_controlnet.main,
                 "pca_scores": pca_scores.main}

        # the ControlNet CLI's condition and its first residuals, recorded
        conditions, residual_rms = [], {}
        make_condition = cli_controlnet.make_condition

        def recording_condition(*a, **k):
            conditions.append(make_condition(*a, **k))
            return conditions[-1]

        def first_residuals(module, inputs, result):
            if isinstance(module, ControlNet) and not residual_rms:
                down, mid = result
                for name, r in (("mid", mid), ("down0", down[0])):
                    residual_rms[name] = r.float().pow(2).mean().sqrt().item()

        wrappers, plain = kernels.wrappers(), plain_cuda_counts()
        for w in wrappers.values():
            w.launches = 0
        for d in plain.values():
            d.plain_cuda_calls = 0
        conv2d.cpu_calls = 0
        kernels.launch_log = collections.Counter()
        runs = {}
        dpt_env = os.environ.get("ED_DPT_DIR")
        os.environ["ED_DPT_DIR"] = dpt_dir
        preprocessors._builtin_depth_fn = None
        cli_controlnet.make_condition = recording_condition
        try:
            for name, argv in argvs.items():
                before = {k: w.launches for k, w in wrappers.items()}
                hook = torch.nn.modules.module.register_module_forward_hook(
                    first_residuals) if name == "cli_controlnet" else None
                buf = io.StringIO()
                torch.cuda.reset_peak_memory_stats()
                t0 = time.time()
                try:
                    with contextlib.redirect_stdout(buf):
                        save_dir = mains[name](argv)
                    torch.cuda.synchronize()
                finally:
                    if hook is not None:
                        hook.remove()
                print(buf.getvalue(), end="", flush=True)
                runs[name] = {
                    "seconds": time.time() - t0, "save_dir": save_dir,
                    "stdout": buf.getvalue().splitlines(),
                    "max_memory_allocated": torch.cuda.max_memory_allocated(),
                    "launches": {k: w.launches - before[k]
                                 for k, w in wrappers.items()}}
                preprocessors._builtin_depth_fn = None
                gc.collect()
                torch.cuda.empty_cache()
        finally:
            cli_controlnet.make_condition = make_condition
            preprocessors._builtin_depth_fn = None
            if dpt_env is None:
                os.environ.pop("ED_DPT_DIR", None)
            else:
                os.environ["ED_DPT_DIR"] = dpt_env
            log = kernels.launch_log
            kernels.launch_log = None
        totals = {k: w.launches for k, w in wrappers.items()}
        plain_calls = {k: d.plain_cuda_calls for k, d in plain.items()}

        # the two CLI requests on the source bundle, the CLI's runtime
        bundle.set_conv_impl(cli.runtime_config(
            cli.build_parser().parse_args(argvs["cli"])).conv_impl)
        try:
            for name in ("cli", "cli_controlnet"):
                opt = cli.build_parser(name != "cli").parse_args(argvs[name])
                ref = ElasticDiffusion(
                    device="cuda", bundle=bundle, sd_version=opt.sd_version,
                    runtime=cli.runtime_config(opt), verbose=opt.verbose,
                    log_freq=opt.log_freq, low_vram=opt.low_vram,
                    view_batch_size=opt.view_batch_size)
                ref.seed_everything(opt.seed)
                kw = cli.request_kwargs(opt)
                if name == "cli_controlnet":
                    # the condition alone (the DPT in fp32, cuDNN convs):
                    # its seconds and its peak above what is resident
                    torch.cuda.synchronize()
                    resident = torch.cuda.memory_allocated()
                    torch.cuda.reset_peak_memory_stats()
                    t0 = time.time()
                    cond = cli_controlnet.make_condition(opt, ref,
                                                         make_depth_fn(dpt))
                    torch.cuda.synchronize()
                    runs[name]["condition_seconds"] = time.time() - t0
                    runs[name]["condition_peak_above_resident"] = \
                        torch.cuda.max_memory_allocated() - resident
                    runs[name]["condition_equal"] = bool(
                        len(conditions) == 1
                        and np.array_equal(cond, conditions[0]))
                    runs[name]["condition_std"] = float(cond.std())
                    runs[name]["controlnet_residual_rms_first_step"] = \
                        residual_rms
                    kw.update(condition_image=cond,
                              controlnet_conditioning_scale=
                              opt.controlnet_conditioning_scale)
                imgs, _ = ref.generate_image(**kw)
                want = np.asarray(imgs[0].convert("RGB"))
                got = np.asarray(Image.open(os.path.join(
                    runs[name]["save_dir"], "0.png")).convert("RGB"))
                same_shape = got.shape == want.shape
                runs[name].update(
                    png_shape=list(got.shape),
                    png_std=float(got.std()),
                    equal_to_source_bundle_run=bool(
                        same_shape and np.array_equal(got, want)),
                    max_abs_uint8=int(np.abs(got.astype(np.int16) - want).max())
                    if same_shape else None)
                del ref, imgs
        finally:
            bundle.set_conv_impl(path["conv_impl"])

        pca_dir = runs["pca_scores"]["save_dir"]
        logged = -(-steps // PCA_LOG_FREQ)
        pngs = {"final.png": PCA_SIZE}
        vsf = bundle.vae_scale_factor
        for k, size in (("direction_pca", PCA_SIZE // vsf),
                        ("uncond_pca", PCA_SIZE // vsf),
                        ("inter_x0", PCA_SIZE)):
            pngs.update({f"{k}_{i}.png": size for i in range(logged)})
        sizes = {f: Image.open(os.path.join(pca_dir, f)).size
                 if os.path.isfile(os.path.join(pca_dir, f)) else None
                 for f in pngs}
        runs["pca_scores"]["pngs"] = sizes
        runs["pca_scores"]["written"] = sorted(os.listdir(pca_dir))
    mem_lines = [l for l in runs["pca_scores"]["stdout"]
                 if l.startswith("[mem] cuda:")]
    metrics = [l for l in runs["cli"]["stdout"] if l.startswith("[metrics]")]
    for r in runs.values():
        r.pop("save_dir")
    unchecked = {} if checked is None else {
        "/".join(map(str, key)): n for key, n in sorted(log.items(), key=str)
        if key not in checked}
    cpu_calls = conv2d.cpu_calls  # the source-bundle runs too
    out.update(runs=runs, launches=totals, plain_versions_on_cuda=plain_calls,
               cpu_conv_calls=cpu_calls,
               unchecked_launches=unchecked)
    emit(out)
    if unchecked:
        fail(f"apps: kernels launched at shapes that no kernel case checks: "
             f"{sorted(unchecked)}")
    if any(plain_calls.values()):
        fail(f"a plain version stood in for a kernel on the GPU: {plain_calls}")
    check_cpu_rule("apps", cpu_calls)
    for name, r in runs.items():
        never = [k for k in ("flash_attention", "fused_layer_norm",
                             "fused_group_norm") if r["launches"][k] == 0]
        if never:
            fail(f"apps {name}: never launched: {never}")
    for name in ("cli", "cli_controlnet"):
        r = runs[name]
        if not r["equal_to_source_bundle_run"]:
            fail(f"apps {name}: its image differs from the same request on "
                 f"the source bundle (max {r['max_abs_uint8']})")
        if not r["png_std"] > 0:
            fail(f"apps {name}: its image is constant")
    cn = runs["cli_controlnet"]
    if not (cn["condition_equal"] and cn["condition_std"] > 0):
        fail(f"apps cli_controlnet: condition not the source DPT's or "
             f"constant: {cn['condition_std']}")
    if not (len(residual_rms) == 2
            and all(v > 0 for v in residual_rms.values())):
        fail(f"apps cli_controlnet: the ControlNet's residuals are zero at "
             f"the first step: {residual_rms}")
    bad = {f: s for f, s in runs["pca_scores"]["pngs"].items()
           if s != (pngs[f], pngs[f])}
    if bad:
        fail(f"apps pca_scores: missing or misshapen images: {bad}")
    if not mem_lines or not metrics:
        fail("apps: no [mem] line from the PCA app or no [metrics] line from "
             "the CLI")
    return log, totals


# ---------------------------------------------------------------------------
# mesh: the elastic step and the halo decode split over two ranks
# ---------------------------------------------------------------------------

MESH_PATH = {"name": "mesh", "sd_version": "XL1.0", "conv_impl": "kernel",
             "requests": ({"height": MESH_LATENT[0] * 8,
                           "width": MESH_LATENT[1] * 8,
                           "tiled_decoder": True},)}
# seconds the ranks may take, set-up included; a rank's collectives give up
# after MESH_COLLECTIVE_SECONDS, so that one rank's failure fails the others
MESH_SECONDS, MESH_COLLECTIVE_SECONDS = 600, 300
# the mesh decode against decode_latents on the same latent: fp32, TF32 off,
# the bands' GroupNorm sums added in another order (the decode phase's bar)
MESH_DECODE_TOL_REL_L2 = 1e-4


def _digest(t) -> str:
    import hashlib
    return hashlib.sha256(torch.as_tensor(t).contiguous().cpu().numpy()
                          .tobytes()).hexdigest()


def mesh_rank(rank: int, world: int, backend: str, tmp: str, seed: int,
              steps: int, resampling: int) -> None:
    """One rank of the mesh phase (the target of a spawned process): the
    SDXL bundle of the sdxl path, perturbed from the same seed, on a
    (1, world) mesh; one request with the launch counts set to 0 just
    before and read just after; the mesh decode of its final latent again,
    raw; on rank 0 also decode_latents of that latent and the same request
    on one GPU. Writes what the parent checks to rank{rank}.json; a
    failure raises, and the process prints its traceback and exits 1."""
    import datetime
    import os

    import torch.distributed as dist
    from elasticdiffusion_tpu_torch.configs import RuntimeConfig
    from elasticdiffusion_tpu_torch.core.pipeline import ElasticDiffusion
    from elasticdiffusion_tpu_torch.models.registry import load_bundle
    from elasticdiffusion_tpu_torch.parallel import halo_decode as hd
    from elasticdiffusion_tpu_torch.parallel.sharding import make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.environ["LOCAL_RANK"] = str(rank)
    dist.init_process_group(
        backend, store=dist.FileStore(f"{tmp}/store", world), rank=rank,
        world_size=world,
        timeout=datetime.timedelta(seconds=MESH_COLLECTIVE_SECONDS))
    try:
        mesh = make_mesh((1, world), backend=backend)
        t0 = time.time()
        bundle = load_bundle("XL1.0", seed=seed, device="cuda",
                             runtime=RuntimeConfig(conv_impl="kernel"))
        perturb_bundle(bundle, seed + 1)
        pipe = ElasticDiffusion(device="cuda", bundle=bundle, mesh=mesh,
                                sd_version="XL1.0")
        torch.cuda.synchronize()
        load_seconds = time.time() - t0
        req = MESH_PATH["requests"][0]
        rows = []
        unrecord = record_unet_rows(bundle, rows)
        convs = gate_convs(bundle.unet)
        wrappers, plain = kernels.wrappers(), plain_cuda_counts()
        for w in wrappers.values():
            w.launches = 0
        for d in plain.values():
            d.plain_cuda_calls = 0
        for m in convs:
            m.library_cuda_calls = 0
        conv2d.cpu_calls = 0
        kernels.launch_log = collections.Counter()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        imgs, info, _ = generate(pipe, MESH_PATH, req, steps, resampling, 0)
        wall = time.time() - t0
        peak = torch.cuda.max_memory_allocated()
        log = kernels.launch_log
        kernels.launch_log = None
        unrecord()
        out = {"rank": rank, "device": str(torch.device(
                   "cuda", torch.cuda.current_device())),
               "load_seconds": load_seconds, "wall_seconds": wall,
               "peak_bytes": peak, "unet_rows": rows,
               "launches": {n: w.launches for n, w in wrappers.items()},
               "plain_versions_on_cuda": {n: d.plain_cuda_calls
                                          for n, d in plain.items()},
               "conv3x3_expected_launches": len(convs) * len(rows),
               "cudnn_calls_in_gate": sum(m.library_cuda_calls
                                          for m in convs),
               "launch_log": [[list(k), n] for k, n in log.items()],
               "last_metrics": pipe.last_metrics,
               "image_shape": list(imgs.shape),
               "image_finite": bool(torch.isfinite(torch.as_tensor(
                   imgs)).all()),
               "digests": {"latent": _digest(info["latent"]),
                           "image": _digest(imgs)}}
        lat = torch.as_tensor(info["latent"], device="cuda")
        z = lat / bundle.config.vae.scaling_factor
        raw = hd.halo_decode(bundle, z, mesh=mesh)
        out["digests"]["mesh_decode"] = _digest(raw)
        if rank == 0:
            out["decode_rel_l2"] = rel_l2(raw, bundle.vae_decode(z))
            del raw
            one = ElasticDiffusion(device="cuda", bundle=bundle,
                                   sd_version="XL1.0")
            one_rows = []
            unrecord = record_unet_rows(bundle, one_rows)
            _, one_info, _ = generate(one, MESH_PATH, req, steps, resampling, 0)
            unrecord()
            out["one_gpu_rows"] = one_rows
            out["one_gpu_metrics"] = one.last_metrics
            out["rel_l2_to_one_gpu"] = rel_l2(
                torch.as_tensor(info["latent"]),
                torch.as_tensor(one_info["latent"]))
        out["cpu_conv_calls"] = conv2d.cpu_calls
        dist.barrier()
    finally:
        dist.destroy_process_group()
    with open(f"{tmp}/rank{rank}.json", "w") as f:
        json.dump(out, f)


def record_unet_rows(bundle, rows: list):
    """Append the rows of every ``bundle.apply_unet`` call to `rows`, a
    call replayed from a CUDA graph too (it runs no module hook). Returns
    the function that stops it."""
    apply = bundle.apply_unet

    def recorded(latent, *args, **kwargs):
        rows.append(int(latent.shape[0]))
        return apply(latent, *args, **kwargs)

    bundle.apply_unet = recorded
    return lambda: delattr(bundle, "apply_unet")


def phase_mesh(seed: int, steps: int, resampling: int, smi: str,
               checked=None):
    """The mesh phase. Two ranks, each a spawned process: on one GPU both on
    cuda:0 under gloo (NCCL takes one rank a device), on two or more one
    GPU a rank under NCCL. The parent releases its CUDA cache first, joins
    the ranks within MESH_SECONDS (a rank that exits non-zero or outlives
    it fails the run; its traceback is on stderr) and checks: the ranks'
    final latents, images and mesh decodes bitwise equal; the final latent
    within E2E_TOL_REL_L2 of the same request on one GPU; the mesh decode
    within MESH_DECODE_TOL_REL_L2 of decode_latents; each rank's UNet rows
    the padded one-GPU rows / MESH_WORLD at every call; each rank's
    launches as on a path of the requests phase."""
    import tempfile

    import torch.multiprocessing as mp
    gpus = torch.cuda.device_count()
    backend = "nccl" if gpus >= MESH_WORLD else "gloo"
    world = MESH_WORLD
    emit({"phase": "mesh_ranks", "backend": backend, "world_size": world,
          "devices": [f"cuda:{r % gpus}" for r in range(world)]})
    gc.collect()
    torch.cuda.empty_cache()
    ctx = mp.get_context("spawn")
    t0 = time.time()
    with tempfile.TemporaryDirectory() as tmp:
        procs = [ctx.Process(target=mesh_rank, args=(
            r, world, backend, tmp, seed, steps, resampling))
            for r in range(world)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(max(1.0, t0 + MESH_SECONDS - time.time()))
        late = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        codes = [p.exitcode for p in procs]
        if late or any(codes):
            fail(f"mesh: ranks {late} outlived {MESH_SECONDS} s; exit codes "
                 f"{codes} (tracebacks above, on stderr)")
        ranks = []
        for r in range(world):
            with open(f"{tmp}/rank{r}.json") as f:
                ranks.append(json.load(f))
    seconds = time.time() - t0
    first = ranks[0]
    one_rows = first["one_gpu_rows"]
    padded = [n + (-n) % world for n in one_rows]
    log = collections.Counter()
    for r in ranks:
        for key, n in r["launch_log"]:
            log[tuple(key)] += n
    unchecked = {} if checked is None else {
        "/".join(map(str, key)): n for key, n in sorted(log.items(), key=str)
        if key not in checked}
    totals = collections.Counter()
    for r in ranks:
        totals.update(r["launches"])
    per_rank = [{k: r[k] for k in (
        "rank", "device", "load_seconds", "wall_seconds", "peak_bytes",
        "launches", "plain_versions_on_cuda", "conv3x3_expected_launches",
        "cudnn_calls_in_gate", "cpu_conv_calls", "unet_rows",
        "image_shape", "digests")}
        | {"denoise_seconds": r["last_metrics"]["denoise_seconds"],
           "decode_seconds": r["last_metrics"]["decode_seconds"],
           "collectives": r["last_metrics"]["collectives"]}
        for r in ranks]
    emit({"phase": "mesh", "nvidia_smi": smi, "backend": backend,
          "world_size": world, "mesh": [1, world], "request": MESH_PATH[
              "requests"][0], "steps": steps, "resampling_steps": resampling,
          "seconds": seconds, "ranks": per_rank,
          "one_gpu_rows": one_rows, "padded_rows": padded,
          "one_gpu_denoise_seconds": first["one_gpu_metrics"][
              "denoise_seconds"],
          "one_gpu_decode_seconds": first["one_gpu_metrics"][
              "decode_seconds"],
          "rel_l2_to_one_gpu": first["rel_l2_to_one_gpu"],
          "tolerance_rel_l2": E2E_TOL_REL_L2,
          "decode_rel_l2": first["decode_rel_l2"],
          "decode_tolerance_rel_l2": MESH_DECODE_TOL_REL_L2,
          "unchecked_launches": unchecked,
          "note": "two ranks sharing one card when the backend is gloo: "
                  "the seconds are not a speed"})
    if unchecked:
        fail(f"mesh: kernels launched at shapes that no kernel case checks: "
             f"{sorted(unchecked)}")
    for r in ranks:
        name = f"mesh rank {r['rank']}"
        if any(r["plain_versions_on_cuda"].values()):
            fail(f"{name}: a plain version stood in for a kernel on the GPU: "
                 f"{r['plain_versions_on_cuda']}")
        check_cpu_rule(name, r["cpu_conv_calls"])
        never = [n for n, c in r["launches"].items() if c == 0]
        if never:
            fail(f"{name}: never launched: {never}")
        if r["launches"]["conv3x3"] != r["conv3x3_expected_launches"] \
                or r["cudnn_calls_in_gate"]:
            fail(f"{name}: conv3x3 launched {r['launches']['conv3x3']} times "
                 f"for {r['conv3x3_expected_launches']}, the library conv "
                 f"{r['cudnn_calls_in_gate']} times in the gate")
        if r["unet_rows"] != [n // world for n in padded]:
            fail(f"{name}: UNet rows {r['unet_rows']}, not the padded rows "
                 f"{padded} / {world}")
        if r["digests"] != first["digests"]:
            fail(f"{name}: not bitwise equal to rank 0: {r['digests']} "
                 f"against {first['digests']}")
        if r["image_shape"] != [1, 3, MESH_LATENT[0] * 8,
                                MESH_LATENT[1] * 8] or not r["image_finite"]:
            fail(f"{name}: image {r['image_shape']}, finite "
                 f"{r['image_finite']}")
    if [sum(r["unet_rows"][i] for r in ranks) for i in range(len(padded))] \
            != padded or not all(a < b for a, b in zip(first["unet_rows"],
                                                        one_rows)):
        fail(f"mesh: the ranks' rows do not add up to the padded rows "
             f"{padded}, or a rank ran a whole batch")
    if not first["rel_l2_to_one_gpu"] <= E2E_TOL_REL_L2:
        fail(f"mesh: final latent {first['rel_l2_to_one_gpu']} rel L2 from "
             f"the one-GPU run, over {E2E_TOL_REL_L2}")
    if not first["decode_rel_l2"] <= MESH_DECODE_TOL_REL_L2:
        fail(f"mesh: mesh decode {first['decode_rel_l2']} rel L2 from "
             f"decode_latents, over {MESH_DECODE_TOL_REL_L2}")
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
    ap.add_argument("--chunk-budgets", default="",
                    help="comma-separated slab budgets (bytes) at which the "
                         "decode phase also times the streamed route")
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

    # the port's numerics: fp32 matmuls and fp32 convolutions stay fp32.
    # The --fp32 paths run under PyTorch's defaults instead, read here
    tf32_defaults = (torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32)
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
    if "api" in phases:
        phase_api()

    logs, totals = {}, collections.Counter()
    budgets = [int(float(b)) for b in opt.chunk_budgets.split(",") if b]
    per_path = {"model", "graphs", "requests", "decode"} & set(phases)
    if per_path or "apps" in phases:
        from elasticdiffusion_tpu_torch.core.pipeline import ElasticDiffusion
        from elasticdiffusion_tpu_torch.models.registry import load_bundle
        wanted = [p for p in opt.paths.split(",") if p]
        for path in PATHS:
            if path["name"] not in wanted or not (
                    per_path or path["name"] == APPS_PATH):
                continue
            if path.get("fp32"):
                # the package itself must keep fp32 in fp32: PyTorch's
                # default flags (cuDNN's TF32 on) around the path
                (torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32) = tf32_defaults
            t0 = time.time()
            bundle = load_bundle(
                path["sd_version"], seed=opt.seed, device="cuda",
                runtime=path_runtime(path),
                controlnet_model=path.get("controlnet"))
            moved = perturb_bundle(bundle, opt.seed + 1)
            torch.cuda.synchronize()
            emit({"phase": "load", "path": path["name"],
                  "sd_version": path["sd_version"], "seconds": time.time() - t0,
                  "memory_allocated": torch.cuda.memory_allocated(),
                  "perturbed_tensors": moved})
            if "model" in phases and "latent" in path:
                with torch.no_grad():
                    if bundle.controlnet is None:
                        phase_model(bundle, path)
                    else:
                        phase_controlnet_model(bundle, path)
            if "graphs" in phases and "graph_rows" in path:
                phase_graphs(bundle, path)
            if "graphs" in phases and "pair_rows" in path:
                phase_graph_pairs(bundle, path)
            if "requests" in phases:
                pipe = ElasticDiffusion(device="cuda", bundle=bundle,
                                        sd_version=path["sd_version"],
                                        controlnet_model=path.get("controlnet"))
                logs[path["name"]], t = phase_requests(
                    pipe, path, path.get("steps", opt.steps),
                    opt.resampling_steps, checked)
                totals.update(t)
                del pipe
            if "decode" in phases and "decode" in path:
                logs[path["name"] + "_decode"], t = phase_decode(
                    bundle, path, checked, budgets)
                totals.update(t)
            if "apps" in phases and path["name"] == APPS_PATH:
                t0 = time.time()
                logs["apps"], t = phase_apps(bundle, path, checked, opt.steps,
                                             opt.resampling_steps)
                totals.update(t)
                emit({"phase": "apps_seconds", "seconds": time.time() - t0})
            if path.get("fp32") and (
                    torch.backends.cuda.matmul.allow_tf32,
                    torch.backends.cudnn.allow_tf32) != tf32_defaults:
                fail(f"{path['name']}: the TF32 flags changed under the path")
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
            # one bundle at a time on the card
            del bundle
            gc.collect()
            torch.cuda.empty_cache()
    if "mesh" in phases:
        t0 = time.time()
        logs["mesh"], t = phase_mesh(opt.seed, opt.steps,
                                     opt.resampling_steps, smi, checked)
        totals.update(t)
        emit({"phase": "mesh_seconds", "seconds": time.time() - t0})

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
                          "library_device_ms", "tflops", "fma_bound_ms",
                          "library_backend"):
                if extra in r:
                    listed[-1][extra] = r[extra]
        for kernel in (k for k, n in totals.items() if n):
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
    runs = len(PATHS) + sum("decode" in p for p in PATHS) + 2  # apps, mesh
    if (set(phases) != set(ALL_PHASES) or len(logs) != runs
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
