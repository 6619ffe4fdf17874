"""The traced run: ``torch.profiler`` over the whole measured window, kept
in memory and reduced to the device's busy time, kernel time by name and
the idle gaps named by what the host was doing.

The host's activity is named by ranges that the benchmark's own files put
around the port's layer entry points (``wrap_layers``); a target that the
port no longer has is skipped. No metric depends on these ranges: they
name the idle gaps of the ``breakdown`` only.
"""

from __future__ import annotations

import bisect
import functools
import importlib
import re
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import torch
from torch.profiler import ProfilerActivity, profile, record_function

WINDOW = "portbench.window"
IMAGE = "portbench.image"
LAYER = "layer:"
# (module, attribute path): the port's layer entry points
LAYER_ENTRIES = (
    ("elasticdiffusion_tpu_torch.core.pipeline", "ElasticDiffusion._context"),
    ("elasticdiffusion_tpu_torch.core.pipeline", "ElasticDiffusion._schedule"),
    ("elasticdiffusion_tpu_torch.core.signals", "approximate_latent_direction"),
    ("elasticdiffusion_tpu_torch.core.signals", "compute_local_uncond_signal"),
    ("elasticdiffusion_tpu_torch.core.signals", "undo_step"),
    ("elasticdiffusion_tpu_torch.models.registry", "ModelBundle.apply_unet"),
    ("elasticdiffusion_tpu_torch.models.registry", "ModelBundle.vae_decode"),
    ("elasticdiffusion_tpu_torch.parallel.halo_decode", "halo_decode"),
)
TOP = 10
NAME_CHARS = 160  # a kernel's name in the breakdown, cut to this length


def wrap_layers(entries: Iterable[Tuple[str, str]] = LAYER_ENTRIES) -> Callable[[], None]:
    """Wrap each entry point in a ``record_function`` range named
    ``layer:<attribute path>``; returns the function that unwraps them."""
    undo = []
    for mod_name, path in entries:
        try:
            owner = importlib.import_module(mod_name)
        except ImportError:
            continue
        *parents, attr = path.split(".")
        for p in parents:
            owner = getattr(owner, p, None)
            if owner is None:
                break
        orig = getattr(owner, attr, None) if owner is not None else None
        if orig is None:
            continue
        raw = owner.__dict__.get(attr, orig) if isinstance(owner, type) else orig

        def wrapped(*a, _f=raw, _n=LAYER + path, **k):
            with record_function(_n):
                return _f(*a, **k)
        setattr(owner, attr, functools.wraps(raw)(wrapped))
        undo.append((owner, attr, raw))

    def unwrap():
        for owner, attr, raw in reversed(undo):
            setattr(owner, attr, raw)
    return unwrap


def start() -> profile:
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.__enter__()
    return prof


@dataclass
class Trace:
    """What one traced window holds, in seconds."""

    window_s: float
    busy_s: float
    kernels: Dict[str, float] = field(default_factory=dict)  # device s by name
    idle_by_host: Dict[str, float] = field(default_factory=dict)

    def kernel_seconds(self, patterns: List[str]) -> float:
        """Device seconds of the kernels whose name matches any pattern."""
        rx = [re.compile(p) for p in patterns]
        return sum(s for n, s in self.kernels.items() if any(r.search(n) for r in rx))

    def breakdown(self) -> dict:
        top = lambda d: [[k[:NAME_CHARS], v] for k, v in
                         sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]
        return {"device_ops": top(self.kernels), "idle_gaps": top(self.idle_by_host)}


def _merge(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def _host_label(ranges: List[Tuple[int, int, str]], starts: List[int], t: int) -> str:
    """The innermost host range (the latest started) that holds time t."""
    i = bisect.bisect_right(starts, t) - 1
    while i >= 0:
        s, e, name = ranges[i]
        if e >= t:
            return name
        i -= 1
    return "outside any image"


def stop(prof: profile) -> Trace:
    """End the profile and reduce it (``reduce``)."""
    torch.cuda.synchronize()
    prof.__exit__(None, None, None)
    return reduce(prof.profiler.kineto_results.events())


def reduce(events) -> Trace:
    """Kineto events -> ``Trace``: the window is the ``WINDOW`` range; the
    device is busy where a kernel, copy or set runs; each idle stretch is
    named by the innermost host range at its start."""
    cuda = torch.autograd.DeviceType.CUDA
    win: Optional[Tuple[int, int]] = None
    ranges: List[Tuple[int, int, str]] = []
    dev: List[Tuple[int, int, str]] = []
    for ev in events:
        name = ev.name()
        annotation = ev.is_user_annotation() or name.startswith(("portbench.", LAYER))
        if ev.device_type() == cuda:
            if not annotation:
                dev.append((ev.start_ns(), ev.end_ns(), name))
        elif name == WINDOW:
            win = (ev.start_ns(), ev.end_ns())
        elif name == IMAGE or name.startswith(LAYER):
            ranges.append((ev.start_ns(), ev.end_ns(), name[len(LAYER):]
                           if name.startswith(LAYER) else "image, outside the layers"))
    if win is None:
        raise RuntimeError("the profile holds no window range")
    w0, w1 = win
    kernels: Dict[str, float] = {}
    spans = []
    for s, e, name in dev:
        s, e = max(s, w0), min(e, w1)
        if e <= s:
            continue
        kernels[name] = kernels.get(name, 0.0) + (e - s) / 1e9
        spans.append((s, e))
    busy = _merge(spans)
    ranges.sort()
    starts = [r[0] for r in ranges]
    idle: Dict[str, float] = {}
    prev = w0
    for s, e in busy + [(w1, w1)]:
        if s > prev:
            label = _host_label(ranges, starts, prev)
            idle[label] = idle.get(label, 0.0) + (s - prev) / 1e9
        prev = max(prev, e)
    return Trace(window_s=(w1 - w0) / 1e9,
                 busy_s=sum(e - s for s, e in busy) / 1e9,
                 kernels=kernels, idle_by_host=idle)
