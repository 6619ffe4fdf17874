"""One run of one cell of the port's benchmark.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with the cell's GPUs. Set-up
builds the port's kernels (or finds them in ``build/kernels`` of the
checkout), makes the cell's weights on the device from the seed, loads them
into the port's ``ElasticDiffusion`` (at the configuration's runtime,
``program.runtime_config``, and with its ControlNet where it has one) and
makes one short warm-up image of the cell's size. The window is a closed
loop of one user: images of the cell's traffic mix (with a ControlNet
condition drawn from each image's seed before its clock starts), one at a
time, each starting when the last has ended, as long as fewer than
``--seconds`` have passed; it ends when the last image ends. ``--trace 1`` reports the per-layer metrics instead of the
end-to-end ones: those of the program's spans and counters from the same
untraced window, the trace's from a second window of ``--seconds`` under
``torch.profiler`` after it (the profiler slows the host).

Then one image of the window, drawn from the seed, is held to the plain
float32 reference (``check.py``), and the run prints the numbers beside
their limits, last on standard error and last in the result: the one JSON
line that ends standard output.
"""

import time

T0 = time.time()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import List, Optional  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# top-level module names that no run may load: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "elasticdiffusion_tpu")


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name (before the first dot, compared
    whole: the port's name begins with the JAX package's) is forbidden."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


@dataclass
class Run:
    """What a finished run holds, for the metric readers: the measured
    window's images and seconds and, in a traced run, the trace of the
    traced window that follows it and the number of images in that."""

    images: list
    window_s: float
    setup_s: float
    peak_bytes: int
    costs: dict
    trace: Optional[object] = None
    traced_images: int = 0


def _power_limit() -> Optional[str]:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else None


def _window(pipe, cell, reqs, seconds: float, cuda: bool, mark) -> tuple:
    """A closed loop of one user: images from `reqs`, each starting when
    the last has ended, while fewer than `seconds` have passed. Returns the
    images and the seconds from the first's start to the last's end."""
    from portbench import host, program
    from portbench import trace as tr

    from portbench import traffic as traffic_mod

    images = []
    w0 = time.time()
    while time.time() - w0 < seconds:
        req = next(reqs)
        cond = traffic_mod.condition_image(cell.traffic, req["seed"],
                                           "cuda" if cuda else "cpu")
        clock, probe = program.StepClock(cuda), host.Probe()
        t_img = time.time()
        with mark(tr.IMAGE):
            out = program.generate(pipe, cell.traffic, cell.steps, req, clock, cond)
        images.append({**req, **out, "wall_s": time.time() - t_img,
                       "steps_s": clock.durations(), "host": probe.read()})
    return images, time.time() - w0


def run_cell(cell, seed: int, seconds: float, trace: bool, device: str = "cuda",
             t0: float = None, metric_names: Optional[List[str]] = None) -> dict:
    """Set-up, window and check of one run; returns the result object.
    With `trace`, a second window of `seconds` runs under the profiler
    after the measured one. `metric_names` defaults to the cell's
    end-to-end metrics (per-layer with `trace`); on a CPU device (tests)
    nothing is traced or timed on a device."""
    import torch
    from torch.profiler import record_function

    from portbench import check, costmodel, program
    from portbench import trace as tr
    from portbench import traffic as traffic_mod
    from portbench import weights as wts
    from portbench.cells import metric_reader
    from portbench.reference.elastic import build_view_plan

    t0 = T0 if t0 is None else t0
    cfg, trf, steps = cell.config, cell.traffic, cell.steps
    cuda = torch.device(device).type == "cuda"
    torch.set_grad_enabled(False)
    parts, last = {}, [t0]

    def lap(name):
        if cuda:
            torch.cuda.synchronize()
        now = time.time()
        parts[name], last[0] = now - last[0], now

    lap("imports")
    torch.zeros(1, device=device)
    lap("device")
    weights = wts.make_weights(cfg, seed, device)
    lap("weights")
    pipe = program.build_pipe(cfg, weights, device)
    del weights
    lap("bundle")
    warm = next(traffic_mod.requests(trf, seed, 1))
    program.generate(pipe, trf, min(2, steps), warm, None,
                     traffic_mod.condition_image(trf, warm["seed"], device))
    lap("warmup")
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.time() - t0

    reqs = traffic_mod.requests(trf, seed)
    images, window_s = _window(pipe, cell, reqs, seconds, cuda, lambda _: contextlib.nullcontext())
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    traced, traced_images = None, 0
    if trace:
        unwrap = tr.wrap_layers()
        prof = tr.start()
        with record_function(tr.WINDOW):
            more, _ = _window(pipe, cell, reqs, seconds, cuda, record_function)
        traced = tr.stop(prof)
        unwrap()
        traced_images = len(more)
        del more
    del pipe
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    vsf = 2 ** (len(cfg["vae"]["block_out_channels"]) - 1)
    views = build_view_plan(trf["height"] // vsf, trf["width"] // vsf,
                            cfg["unet"]["sample_size"], "cpu").num_views
    run = Run(images=images, window_s=window_s, setup_s=setup_s, peak_bytes=peak,
              costs=costmodel.image_costs(cfg, trf, steps, views), trace=traced,
              traced_images=traced_images)
    entries = cell.per_layer if trace else cell.end_to_end
    if metric_names is not None:
        entries = [{"name": n, "unit": ""} for n in metric_names]
    metrics = {}
    for m in entries:
        value = metric_reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    record = images[check.sample_index(seed, len(images))]
    weights = wts.make_weights(cfg, seed, device)
    ref = check.reference_outputs(cfg, trf, steps, weights, record, device)
    unit = check.reference_outputs(cfg, trf, steps, weights, record, device,
                                   mode="unit", decode=False)
    del weights
    values = check.program_readings(record, ref, unit)
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": cell.chips, "memory_peak_bytes": peak}
    if cuda:
        dev["power_limit"] = _power_limit()
    if traced is not None:
        dev["busy_s"], dev["window_s"] = traced.busy_s, traced.window_s
    result = {"correct": check.judge(values, cell.limits),
              "attempted": len(images) + traced_images, "failed": 0,
              "metrics": metrics, "device": dev}
    if traced is not None:
        result["breakdown"] = traced.breakdown()
    result["setup_parts"] = parts
    result["images"] = [{"wall_s": img["wall_s"], **{
        k: img["metrics"].get(k) for k in ("preamble_seconds", "denoise_seconds",
                                           "decode_seconds")}, **img["host"]}
        for img in images]
    steps_of = {name: i for name, (i, _, _) in ref["steps"].items()}
    result["checks"] = {k: {"value": values[k], "limit": cell.limits[k],
                            **({"step": steps_of[k]} if k in steps_of else {})}
                        for k in check.NUMBERS}
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    # every kernel cache at a fixed path inside the checkout
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    sys.path.insert(0, str(ROOT))
    import torch

    from portbench.cells import load_cell
    cell = load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: the cell needs {cell.chips} CUDA device(s); "
              f"available: {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    found = forbidden_modules()
    if found:
        print(f"portbench: the run loaded {', '.join(found)}", file=sys.stderr)
        return 3
    for k, img in enumerate(result.pop("images")):
        print(f"image {k}: " + " ".join(f"{n} {v!r}" for n, v in img.items()),
              file=sys.stderr)
    print("setup: " + " ".join(f"{n} {v!r}" for n, v in result["setup_parts"].items()),
          file=sys.stderr)
    for k, c in result["checks"].items():
        at = f" (step {c['step']})" if "step" in c else ""
        print(f"check {k}{at} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
