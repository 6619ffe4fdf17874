"""One cell of the port's benchmark with the port's tracer set: what the
spans read, and what the tracer costs.

    python3 tools/trace_cell.py --workload <cell> --seed <n> --seconds <s> [--pairs 6]

From the root of a checkout, on a machine with the cell's GPU. Set-up is
the benchmark's (``portbench/run.py``: the cell's weights from the seed,
the port's bundle through its converter, one 2-step warm-up image, with
the cell's ControlNet condition where it has one); every
window is ``run.py``'s closed loop of ``--seconds``. Then:

1. a window with the tracer off: ``image_s``, the allocator's peak over
   the window (``peak_mem_gib``) and its peak reserved bytes, and each
   image's ``unet_graph_replays`` and ``unet_graph_captures`` (beside the
   warm-up image's captures) and, with a ControlNet, its rows, device
   seconds and ControlNet graph replays and captures;
2. a window under ``torch.profiler`` with ``run.py``'s ranges (the window,
   each image, the ``layer:`` ranges of ``portbench/trace.py``) and the
   tracer set: ``portbench/spans.py``'s readings beside the breakdown's
   ``idle_gaps``, launches and host milliseconds of each ``unet`` span by
   its label and by its label and ``graph`` attribute (replayed, captured
   or eager), each image's ``unet`` spans by that attribute, the launch
   calls against the device's ops, and the shared
   clock: how far each ``layer:ModelBundle.apply_unet`` range starts
   after its ``unet`` span starts and ends before it ends; with a
   ControlNet, its ``controlnet`` and ``cond`` spans' idle seconds,
   launches and host milliseconds, the ``controlnet`` spans also by their
   ``graph`` attribute (``idle_by_span`` names their idle ``controlnet``
   and ``cond``);
3. ``--pairs`` windows with the tracer set and as many with it off, in
   turns (on, off, off, on, ...): ``image_s`` of each, and the largest
   ``preamble`` / ``denoise`` / ``decode`` peak of the windows with it set.

Prints one JSON object on standard output.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _median(xs):
    return statistics.median(xs) if xs else None


def _by_label(events, unets, by_id):
    """Per label of the unet spans, and per label and ``graph`` attribute
    (``direction>unet[16]/replay``; a port without CUDA graphs records
    none): calls, launches (min, max, mean) and the host's milliseconds in
    the span (its enqueue: the span holds no synchronisation), median and
    max."""
    from portbench import spans
    out = {}
    for s, n in zip(unets, spans.launch_counts(events, unets)):
        name = spans.label(s, by_id.get(s.parent))
        for k in (name, f"{name}/{s.attrs['graph']}") if "graph" in s.attrs else (name,):
            out.setdefault(k, []).append((n, (s.t1_ns - s.t0_ns) / 1e6))
    return {k: {"calls": len(v), "min": min(n for n, _ in v),
                "max": max(n for n, _ in v), "mean": sum(n for n, _ in v) / len(v),
                "host_ms_median": _median([ms for _, ms in v]),
                "host_ms_max": max(ms for _, ms in v)} for k, v in out.items()}


def _graph_calls(spans_, by_id):
    """Per image of a traced window, in order: its unet spans by their
    ``graph`` attribute (``replay``, ``capture``, ``eager``; ``none`` on a
    port without the attribute)."""
    per = {}
    for s in spans_:
        if s.name == "unet":
            kinds = per.setdefault(s.image, {})
            g = s.attrs.get("graph", "none")
            kinds[g] = kinds.get(g, 0) + 1
    return [per[k] for k in sorted(per)]


def _runtime_calls(events, win):
    """Inside the window: the host's CUDA API calls (names starting with
    ``cu``) by name, the fifteen most frequent; the launches
    that ``spans.launches`` counts, and every launch call; the device's
    kernels, copies and sets."""
    import torch

    from portbench import spans
    from portbench import trace as tr
    cuda = torch.autograd.DeviceType.CUDA
    inside = lambda e: win[0] <= e.start_ns() <= win[1]
    counts = {}
    for e in events:
        if e.device_type() != cuda and e.name().startswith("cu") and inside(e):
            counts[e.name()] = counts.get(e.name(), 0) + 1
    return {"by_name": dict(sorted(counts.items(), key=lambda kv: -kv[1])[:15]),
            "launches": sum(win[0] <= s <= win[1] for s, _ in spans.launches(events)),
            "launch_calls": sum(n for k, n in counts.items() if k.startswith(spans.LAUNCHES)),
            "device_ops": sum(1 for e in events if e.device_type() == cuda and inside(e)
                              and not e.is_user_annotation()
                              and not e.name().startswith(("portbench.", tr.LAYER)))}


def _clock(events, unets):
    """(start offsets, end offsets) in microseconds: each apply_unet range
    of the profiler against its unet span, matched in order."""
    import torch

    from portbench import trace as tr
    ranges = sorted((e.start_ns(), e.end_ns()) for e in events
                    if e.name() == tr.LAYER + "ModelBundle.apply_unet"
                    and e.device_type() != torch.autograd.DeviceType.CUDA)
    if len(ranges) != len(unets):
        return {"matched": False, "ranges": len(ranges), "spans": len(unets)}
    lead = [(r0 - s.t0_ns) / 1e3 for (r0, _), s in zip(ranges, unets)]
    lag = [(s.t1_ns - r1) / 1e3 for (_, r1), s in zip(ranges, unets)]
    stat = lambda xs: {"min": min(xs), "median": _median(xs), "max": max(xs)}
    return {"matched": True, "n": len(unets), "start_after_span_us": stat(lead),
            "end_before_span_end_us": stat(lag)}


def _span_readings(events, spans_, names):
    """Per span name of `names` (spans that do not nest in one another),
    and per name and ``graph`` attribute where the spans carry one
    (``controlnet/replay``): the window's spans, the device's idle seconds
    inside them, and the launches starting inside them, over the spans;
    empty for names with no span."""
    from portbench import spans
    win, busy = spans.window_and_busy(events)
    gaps = spans.idle_gaps(win, busy)
    starts = [g[0] for g in gaps]
    groups = {}
    for s in sorted(spans_, key=lambda s: s.t0_ns):
        if s.name in names and s.t1_ns is not None and win[0] <= s.t0_ns <= win[1]:
            groups.setdefault(s.name, []).append(s)
            if "graph" in s.attrs:
                groups.setdefault(f"{s.name}/{s.attrs['graph']}", []).append(s)
    out = {}
    for name, some in groups.items():
        if some:
            out[name] = {
                "spans": len(some),
                "idle_s": sum(spans._overlap(gaps, starts, s.t0_ns, s.t1_ns)
                              for s in some) / 1e9,
                "launches_per_span": sum(spans.launch_counts(events, some)) / len(some),
                "host_ms_median": _median([(s.t1_ns - s.t0_ns) / 1e6 for s in some])}
    return out


def measure(cell, seed: int, seconds: float, pairs: int, device: str = "cuda") -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from elasticdiffusion_tpu_torch.utils import trace as ptrace
    from portbench import program, spans
    from portbench import trace as tr
    from portbench import traffic as traffic_mod
    from portbench import weights as wts
    from portbench.run import _window

    cuda = torch.device(device).type == "cuda"
    torch.set_grad_enabled(False)
    cfg, trf, steps = cell.config, cell.traffic, cell.steps
    t0 = time.time()
    weights = wts.make_weights(cfg, seed, device)
    pipe = program.build_pipe(cfg, weights, device)
    del weights
    warm = next(traffic_mod.requests(trf, seed, 1))
    program.generate(pipe, trf, min(2, steps), warm, None,
                     traffic_mod.condition_image(trf, warm["seed"], device))
    setup_s = time.time() - t0
    graphs = getattr(pipe.bundle, "unet_graphs", None)
    warmup_captures = graphs.captures if graphs is not None else None
    reqs = traffic_mod.requests(trf, seed)
    plain = lambda _: contextlib.nullcontext()

    def window(on: bool, mark=plain):
        tracer = ptrace.Tracer() if on else None
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        ptrace.tracer = tracer
        try:
            images, secs = _window(pipe, cell, reqs, seconds, cuda, mark)
        finally:
            ptrace.tracer = None
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        reserved = torch.cuda.max_memory_reserved() if cuda else 0
        return {"image_s": secs / len(images), "images": len(images),
                "peak_bytes": peak, "reserved_bytes": reserved,
                "spans": tracer.spans if on else None,
                "fwd": [img["metrics"]["unet_view_forwards"] for img in images],
                "controlnet": [(img["metrics"].get("controlnet_view_forwards"),
                                img["metrics"].get("controlnet_device_seconds"),
                                img["metrics"].get("controlnet_graph_replays"),
                                img["metrics"].get("controlnet_graph_captures"))
                               for img in images],
                "graph": [(img["metrics"].get("unet_graph_replays"),
                           img["metrics"].get("unet_graph_captures"))
                          for img in images]}

    a = window(False)
    out = {"cell": cell.name, "seed": seed, "seconds": seconds, "setup_s": setup_s,
           "warmup_captures": warmup_captures,
           "window_a": {"image_s": a["image_s"], "images": a["images"],
                        "peak_mem_gib": a["peak_bytes"] / 2 ** 30,
                        "max_reserved_gib": a["reserved_bytes"] / 2 ** 30,
                        "unet_view_forwards": a["fwd"],
                        "unet_graph_replays_captures": a["graph"],
                        "controlnet_rows_seconds_replays_captures": a["controlnet"]}}

    unwrap = tr.wrap_layers()
    prof = profile(activities=[ProfilerActivity.CPU]
                   + ([ProfilerActivity.CUDA] if cuda else []))
    prof.__enter__()
    tracer = ptrace.tracer = ptrace.Tracer()
    try:
        with record_function(tr.WINDOW):
            more, _ = _window(pipe, cell, reqs, seconds, cuda, record_function)
        if cuda:
            torch.cuda.synchronize()
    finally:
        ptrace.tracer = None
        prof.__exit__(None, None, None)
        unwrap()
    events = list(prof.profiler.kineto_results.events())
    readings = spans.read(events, tracer.spans)
    traced = tr.reduce(events)
    by_id = {s.id: s for s in tracer.spans}
    unets = sorted((s for s in tracer.spans if s.name == "unet"), key=lambda s: s.t0_ns)
    out["traced"] = {
        **readings, "images": len(more), "spans_per_image": len(tracer.spans) / len(more),
        "window_s": traced.window_s, "busy_s": traced.busy_s,
        "idle_pct": 100.0 * (1.0 - traced.busy_s / traced.window_s),
        "unet_idle_s": (readings["unet_idle_pct"] or 0.0) * traced.window_s / 100.0,
        "apply_unet_idle_s": traced.idle_by_host.get("ModelBundle.apply_unet"),
        "idle_gaps": traced.breakdown()["idle_gaps"],
        "launches_by_label": _by_label(events, unets, by_id),
        "unet_calls_by_graph": _graph_calls(tracer.spans, by_id),
        "runtime_calls": _runtime_calls(events, spans.window_and_busy(events)[0]),
        "clock": _clock(events, unets),
        "controlnet": _span_readings(events, tracer.spans, ("controlnet", "cond"))}
    del events, prof, tracer, more

    on, off, peaks = [], [], []
    for k in range(pairs):
        for state in ((True, False) if k % 2 == 0 else (False, True)):
            w = window(state)
            (on if state else off).append(w["image_s"])
            if state:
                peaks.append(spans.phase_peaks(w["spans"]))
    phase = {p: max((pk[p] for pk in peaks if pk[p] is not None), default=None)
             for p in spans.PHASES}
    top = max((v for v in phase.values() if v is not None), default=None)
    out["cost"] = {"on": on, "off": off, "median_on": _median(on),
                   "median_off": _median(off),
                   "cost_pct": (100.0 * (_median(on) / _median(off) - 1.0)
                                if on and off else None)}
    out["peaks_gib"] = {**{p: (v / 2 ** 30 if v is not None else None)
                           for p, v in phase.items()},
                        "largest_over_window_a": (top / a["peak_bytes"]
                                                  if top and a["peak_bytes"] else None)}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=20.0)
    p.add_argument("--pairs", type=int, default=6)
    args = p.parse_args(argv)
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    sys.path.insert(0, str(ROOT))
    import torch

    from portbench.cells import load_cell
    from portbench.run import _power_limit
    if not torch.cuda.is_available():
        print("trace_cell: needs a CUDA device", file=sys.stderr)
        return 2
    out = measure(load_cell(args.workload), args.seed, args.seconds, args.pairs)
    out["device"] = {"kind": torch.cuda.get_device_name(0), "power_limit": _power_limit(),
                     "torch": torch.__version__, "cuda": torch.version.cuda}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
