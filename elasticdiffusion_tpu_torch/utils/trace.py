"""Spans of ``generate_image``, on the clock of ``torch.profiler``'s trace.

Off unless an operator turns it on. ``tracer`` is None by default, as
``kernels.launch_log`` is: ``span`` then returns one shared null context and
``begin`` returns it too, so a traced call site costs a None check and the
port reads no clock, allocates nothing on the device and synchronises
nothing for it. To record the calls that follow:

    from elasticdiffusion_tpu_torch.utils import trace
    trace.tracer = trace.Tracer()
    pipe.generate_image(...)
    spans = trace.tracer.spans
    trace.tracer = None

Each ``Span`` holds its id, its parent's id, the id of its image (the root
span's: every span of one ``generate_image`` call shares it), its name, its
start and end in ``time.time_ns()`` nanoseconds and its attributes. The
spans nest by a stack (the port drives the device from one host thread) and
are kept in memory, in the order they began. ``generate_image`` records:

  image      the whole call: height, width, steps, rs, views, B
  preamble   entry to the synchronisation before step 0: peak_bytes
  context    ``_context``: text encoders, plans
  schedule   ``_schedule``: DDIM tables, background tables
  denoise    the step loop, to its synchronisation: peak_bytes
  step       one ``_denoise_step``: i, repaint
  direction  ``approximate_latent_direction``: pass (main / repaint), rs
  picks      ``resolve_resample_picks``: n_sub
  local      ``compute_local_uncond_signal``: views, chunks
  undo       ``undo_step``: micro_steps
  unet       ``signals.unet_step`` (pad, ControlNet, UNet, crop): rows, h
             and w of the padded input, controlnet, graph (how the UNet
             forward ran: ``"replay"`` from a CUDA graph, ``"capture"``
             into one, or ``"eager"``; ``models/unet_graphs.py``)
  controlnet the ControlNet's part of ``ModelBundle.apply_unet`` inside
             ``unet``: rows, h, w, scale, graph (how it ran, as the
             UNet's: its graph replayed, captured, or ``"eager"``)
  cond       the building of the image's ControlNet conditions, once an
             image inside ``context`` (``signals.image_conditions``): h
             and w of the direction's zero-padded condition, view_rows
             (the local signal's ``view_conditions``), view_h and view_w
  decode     the decode of all B images: route, peak_bytes

``preamble``, ``denoise`` and ``decode`` begin and end at the clock reads
of ``last_metrics``' ``preamble_seconds``, ``denoise_seconds`` and
``decode_seconds``. Every other span reads the clock as the host enters and
leaves it: no CUDA event, no synchronisation, so a span's end is when the
host had queued its work, not when the device finished it. Kineto's events
carry the same epoch nanoseconds, so a profiler's device kernels and idle
stretches can be charged to the span the host was in.

``peak_bytes`` (a span begun with ``peak=`` a CUDA device):
``torch.cuda.max_memory_allocated()`` at the span's end, after
``torch.cuda.reset_peak_memory_stats()`` at its start. The reset is the
allocator's own, process-wide counter: while a tracer is set, anyone else
who reads that counter across a ``generate_image`` call (a benchmark's
window peak) reads only what followed the last reset.

Cost while a tracer is set: two clock reads and one small object a span;
an image of 8 steps with repaint, its views in one batch, has 96 spans, and
a ControlNet adds two a UNet call (``controlnet`` and ``cond``).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import torch

tracer: Optional["Tracer"] = None


@dataclass
class Span:
    id: int
    parent: Optional[int]
    image: int
    name: str
    t0_ns: int
    t1_ns: Optional[int] = None
    attrs: Dict[str, Any] = field(default_factory=dict)


class _Null:
    """The span of a call made with no tracer set: does nothing."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        pass

    def end(self, t1_ns: Optional[int] = None, **attrs):
        pass


NULL = _Null()


class _Open:
    """An open span of `tracer`: a context manager that ends it on exit."""

    __slots__ = ("tracer", "span")

    def __init__(self, tracer: "Tracer", span: Span):
        self.tracer, self.span = tracer, span

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.end()
        return False

    def set(self, **attrs):
        self.span.attrs.update(attrs)

    def end(self, t1_ns: Optional[int] = None, **attrs):
        """End the span at `t1_ns` (now if None), with `attrs` added."""
        self.span.attrs.update(attrs)
        self.tracer.end(self.span, time.time_ns() if t1_ns is None else t1_ns)


class Tracer:
    """Spans in memory, in the order they began (``spans``)."""

    def __init__(self):
        self.spans: List[Span] = []
        self._stack: List[tuple] = []   # (open span, device of its peak)

    def begin(self, name: str, t0_ns: int, peak=None,
              attrs: Optional[Dict[str, Any]] = None) -> Span:
        top = self._stack[-1][0] if self._stack else None
        sid = len(self.spans)
        span = Span(sid, None if top is None else top.id,
                    sid if top is None else top.image, name, t0_ns,
                    attrs=dict(attrs or {}))
        self.spans.append(span)
        dev = None
        if peak is not None and torch.device(peak).type == "cuda":
            dev = torch.device(peak)
            torch.cuda.reset_peak_memory_stats(dev)
        self._stack.append((span, dev))
        return span

    def end(self, span: Span, t1_ns: int) -> None:
        """End `span` and every span begun inside it that is still open
        (an exception left them), all at `t1_ns`. A span already ended is
        left as it is."""
        if all(s is not span for s, _ in self._stack):
            return
        while True:
            top, dev = self._stack.pop()
            top.t1_ns = t1_ns
            if dev is not None:
                top.attrs["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
            if top is span:
                return


def begin(name: str, t0_ns: Optional[int] = None, peak=None, **attrs):
    """Open a span at `t0_ns` (now if None) and return it; end it with
    ``.end(t1_ns)`` or a ``with`` block. `peak`: a device whose allocator
    peak the span records as ``peak_bytes`` (CUDA only). The shared null
    span when no tracer is set."""
    tr = tracer
    if tr is None:
        return NULL
    return _Open(tr, tr.begin(name, time.time_ns() if t0_ns is None else t0_ns,
                              peak, attrs))


def span(name: str, peak=None, **attrs):
    """``with span(name, **attrs) as s:``: a span over the block, begun
    now and ended when the block is left. The shared null context when no
    tracer is set."""
    return begin(name, None, peak, **attrs)
