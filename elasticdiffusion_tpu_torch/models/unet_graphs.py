"""CUDA graphs of the UNet forward: one per input key, replayed.

``ModelBundle.apply_unet`` runs the UNet through a ``UNetGraphs``. A UNet
forward is 800-2,400 launches; where the host takes longer to enqueue them
than the device takes to run them, the device waits. A replay enqueues the
whole forward as a few copies and one ``cudaGraphLaunch``.

The key of a call (``graph_key``) is the device, the shape and dtype of
every tensor input (latent, context, SDXL ``added_text_embeds`` and
``added_time_ids``, the ControlNet's residuals), which optional inputs are
present, and the matmul precision flags PyTorch reads at launch. A call
gets no key, and runs eagerly as it always has, when its latent is not on
a CUDA device, when an input lies on another device, or when its timestep
is not a number (the pipeline passes a float).

For a call with a key:

  first sight   eager. The kernels' libraries, cuBLAS and cuDNN handles,
                plans and GroupNorm's counter buffer are set up here,
                outside any capture.
  second sight  capture, then replay. Static inputs are allocated outside
                the capture and filled with ``copy_`` (the timestep with
                ``fill_``: a kernel argument, not a copy from the host).
  later         copy the inputs in, replay.

Every graph of one ``UNetGraphs`` captures into one private memory pool, so
their activations share memory. Replaying one key can then overwrite
another key's static output: every call returns a clone of the static
output, never the pool's memory. A graph captured after a larger one
takes its blocks from the larger one's; the other way round, the larger
one's tensors do not fit the smaller one's blocks and the pool grows by
both. So the pool holds the largest key's graph first: a key larger (by
latent elements) than every graph captured before releases them and the
pool, is captured alone, and the smaller keys are captured again at their
next call.

``drop`` forgets every graph, its static tensors and the pool, and hands
the pool's memory back to the device. The bundle drops them when its
kernels or its convolutions change mode, and ``generate_image`` when the
image's size, batch or view chunk changes. Graphs are also dropped when
the UNet's first or last weight was reallocated (a module ``.to`` or a new
UNet). A reload of weights in place (``convert.load_into``) keeps them:
the weights are channels_last, every kernel reads them where they lie, and
a replay reads the new values.

``replays``, ``captures`` and ``eager`` count the calls of each kind since
the ``UNetGraphs`` was made; ``last`` is the kind of the latest call
(``"replay"``, ``"capture"`` or ``"eager"``). A replay calls no kernel
wrapper, so it adds to the wrappers' counters (``launches``, ``copies``)
and to ``kernels.launch_log`` what its capture counted: they count the
kernels that ran, a replayed call's too.

A call with a ControlNet condition (``pair``) runs the ControlNet and the
UNet beside it as a pair. Its key is ``graph_key`` of the UNet's inputs
plus the condition's shape, dtype and broadcast dims and the conditioning
scale, which the graph bakes in as a number; a call without a condition
keeps its key, its graph and its path. A pair key follows the rules above
(first sight eager, second capture, largest first, the drops) and holds
two graphs in the one pool, captured in this order:

  ControlNet  reads the UNet graph's static latent, timestep, context and
              SDXL inputs, and a static condition of its own: the
              condition's distinct slices (one row where the call's rows
              are one row broadcast) in the ControlNet's dtype, which its
              forward casts to first, so the numbers are the same. Its
              residual outputs are the UNet graph's static residual
              inputs: written in place, never copied.
  UNet        the UNet forward on those residuals.

A replay loads the inputs once, replays the ControlNet's graph inside
``part("replay")`` (the caller's span and clock around the ControlNet
alone), then the UNet's, and returns a clone of the UNet's output. Graphs
are also dropped when the ControlNet's first or last weight was
reallocated.
"""

from __future__ import annotations

import collections
import math
import numbers
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import torch

from .. import kernels

# the optional tensor inputs of ``UNet2DCondition.forward``, in order
EXTRAS = ("added_text_embeds", "added_time_ids", "down_block_residuals",
          "mid_block_residual")

# the kernel wrappers' counters that a replay adds to
COUNTERS = ("launches", "copies")


def _is_number(t) -> bool:
    """Whether a timestep is a number (or a 0-d CPU tensor): what a graph
    takes, filled into its static timestep as a kernel argument. Any other
    timestep runs eagerly."""
    if isinstance(t, torch.Tensor):
        return t.device.type == "cpu" and t.dim() == 0
    return isinstance(t, numbers.Number) and not isinstance(t, bool)


def _flat(latent, context, extras: Dict) -> List[Optional[torch.Tensor]]:
    """The tensor inputs in a fixed order: latent, context, then each
    optional input (None where absent; the down residuals one by one)."""
    flat = [latent, context]
    for name in EXTRAS:
        v = extras.get(name)
        if name == "down_block_residuals" and v is not None:
            flat.extend(v)
        else:
            flat.append(v)
    return flat


def _broadcast(v: torch.Tensor) -> tuple:
    """The dims along which `v` is one slice broadcast (stride 0, more than
    one element): a static copy of it keeps one slice of each."""
    return tuple(d for d in range(v.dim()) if v.stride(d) == 0 and v.shape[d] > 1)


def _distinct(v: torch.Tensor, dims: tuple) -> torch.Tensor:
    """`v` with each dim of `dims` cut to its first slice (a view)."""
    return v[tuple(slice(0, 1) if d in dims else slice(None)
                   for d in range(v.dim()))]


def input_key(latent, t, context, controlnet_cond=None,
              conditioning_scale=1.0, **extras) -> Optional[tuple]:
    """What a graph of a call depends on, on any device: the latent's
    device, every input's shape and dtype, which optional inputs are
    present, the matmul precision flags; with a ControlNet condition, one
    more part: its shape, dtype and broadcast dims and the scale. None for
    a timestep or a scale that is not a number (``_is_number``) or an input
    on another device."""
    if not _is_number(t):
        return None
    if controlnet_cond is not None:
        key = input_key(latent, t, context, **extras)
        if key is None or controlnet_cond.device != latent.device \
                or not _is_number(conditioning_scale):
            return None
        return key + (("controlnet", tuple(controlnet_cond.shape),
                       controlnet_cond.dtype, _broadcast(controlnet_cond),
                       float(conditioning_scale)),)
    dev = latent.device
    parts = []
    for name in EXTRAS:
        v = extras.get(name)
        if v is None:
            parts.append((name, None))
        elif name == "down_block_residuals":
            parts.append((name, tuple((tuple(r.shape), r.dtype) for r in v)))
        else:
            parts.append((name, tuple(v.shape), v.dtype))
    for v in _flat(latent, context, extras):
        if v is not None and v.device != dev:
            return None
    matmul = torch.backends.cuda.matmul
    return (dev, tuple(latent.shape), latent.dtype, tuple(context.shape),
            context.dtype, tuple(parts),
            (matmul.allow_tf32, matmul.allow_bf16_reduced_precision_reduction,
             torch.get_float32_matmul_precision()))


def graph_key(latent, t, context, **extras) -> Optional[tuple]:
    """The key of one ``apply_unet`` call (``input_key``, a ControlNet
    condition included), or None where no graph applies: a latent off
    CUDA."""
    if latent.device.type != "cuda":
        return None
    return input_key(latent, t, context, **extras)


def _size(key: tuple) -> int:
    """The latent elements of a key: what orders keys by the memory their
    forward takes."""
    return math.prod(key[1])


@dataclass
class Counted:
    """What the kernel wrappers counted over a block (``counted``): each
    changed counter's increase, by (wrapper, counter), and the
    ``kernels.launch_log`` entries."""
    counters: Dict[tuple, int] = field(default_factory=dict)
    log: collections.Counter = field(default_factory=collections.Counter)

    def add(self) -> None:
        """Count the block's kernels again, as a replay of it runs them."""
        for (w, name), n in self.counters.items():
            setattr(w, name, getattr(w, name) + n)
        if kernels.launch_log is not None:
            kernels.launch_log.update(self.log)


def _counters() -> Dict[tuple, int]:
    return {(w, name): getattr(w, name)
            for w in kernels.wrappers().values() for name in COUNTERS
            if hasattr(w, name)}


def counted(fn):
    """(``fn()``, ``Counted`` of its kernels). The launch log is recorded
    whether or not one is set, and passed on to the one that is."""
    before = _counters()
    outer, kernels.launch_log = kernels.launch_log, collections.Counter()
    try:
        out = fn()
    finally:
        log, kernels.launch_log = kernels.launch_log, outer
        if outer is not None:
            outer.update(log)
    after = _counters()
    return out, Counted({k: after[k] - n for k, n in before.items()
                         if after[k] != n}, log)


@dataclass
class _Control:
    """The ControlNet's graph of a pair (module docstring)."""
    cond: torch.Tensor                     # static condition, distinct slices
    dims: tuple                            # the call's broadcast dims
    graph: Optional[torch.cuda.CUDAGraph] = None
    residuals: tuple = ()                  # (down list, mid): pool memory
    counted: Counted = field(default_factory=Counted)  # at capture

    def load(self, cond: torch.Tensor) -> None:
        self.cond.copy_(_distinct(cond, self.dims))


@dataclass
class _Graph:
    inputs: List[Optional[torch.Tensor]]   # static tensors, ``_flat`` order
    t: torch.Tensor                        # static fp32 timestep
    graph: Optional[torch.cuda.CUDAGraph] = None
    out: Optional[torch.Tensor] = None     # static output (pool memory)
    counted: Counted = field(default_factory=Counted)  # at capture
    cn: Optional[_Control] = None          # a pair's ControlNet

    def load(self, flat: Sequence[Optional[torch.Tensor]], t) -> None:
        for s, v in zip(self.inputs, flat):
            if s is not None:
                s.copy_(v)
        self.t.fill_(float(t))


def _weights(module, last) -> tuple:
    """What graphs were made for: the module, and where its first weight
    and `last` lie (a ``.to`` or a new module moves them)."""
    return id(module), module.conv_in.weight.data_ptr(), last.data_ptr()


class UNetGraphs:
    """The CUDA graphs of one bundle's UNet, by key (module docstring)."""

    def __init__(self):
        self.seen = set()                  # keys run eagerly once
        self.graphs: Dict[tuple, _Graph] = {}
        self.pool = None                   # private memory pool of all graphs
        self.stream: Optional[torch.cuda.Stream] = None  # capture stream
        self.owner = None                  # the UNet the graphs were made for
        self.cn_owner = None               # the ControlNet of the pairs
        self.image = None                  # ``for_image``'s last shape
        self.replays = self.captures = self.eager = 0
        self.last = "eager"

    def _release(self) -> None:
        """Forget every graph and the pool, and hand its memory back."""
        had = bool(self.graphs)
        self.graphs.clear()
        self.pool = None
        if had:
            torch.cuda.empty_cache()

    def drop(self) -> None:
        """Forget every key, graph, static tensor and the memory pool."""
        self.seen.clear()
        self._release()
        self.owner = self.cn_owner = None

    def for_image(self, shape: tuple) -> None:
        """Drop every graph when `shape` (an image's height, width, batch
        and view chunk) differs from the last image's."""
        if shape != self.image:
            self.drop()
            self.image = shape

    def _own(self, unet, controlnet=None) -> None:
        """Drop every graph made for another UNet or, on a pair's call,
        another ControlNet (or one reallocated): nothing captured before
        may be replayed."""
        owner = _weights(unet, unet.conv_out.weight)
        if owner != self.owner:
            self.drop()
            self.owner = owner
        if controlnet is not None:
            cn = _weights(controlnet, controlnet.controlnet_mid_block.weight)
            if self.cn_owner is not None and cn != self.cn_owner:
                self.drop()
                self.owner = owner
            self.cn_owner = cn

    def _kind(self, key) -> Optional[_Graph]:
        """The kind of a call of `key` (``last``, counted): its graph to
        replay, None to capture one or to run eagerly."""
        g = None if key is None else self.graphs.get(key)
        if g is not None:
            self.last = "replay"
            self.replays += 1
        elif key is not None and key in self.seen:
            if self.graphs and max(map(_size, self.graphs)) < _size(key):
                self._release()   # the largest first (module docstring)
            self.last = "capture"
            self.captures += 1
        else:
            if key is not None:
                self.seen.add(key)
            self.last = "eager"
            self.eager += 1
        return g

    def __call__(self, key, unet, latent, t, context, **extras) -> torch.Tensor:
        """``unet(latent, t, context, **extras)``: eagerly, captured or
        replayed. `key` is ``graph_key`` of the call (None: eagerly); the
        caller holds autograd off and sets the convolution flags."""
        if key is not None:
            self._own(unet)
        g = self._kind(key)
        if g is not None:
            g.load(_flat(latent, context, extras), t)
            g.counted.add()
        elif self.last == "capture":
            g = self._capture(unet, key, latent, t, context, extras)
        else:
            return unet(latent, t, context, **extras)
        g.graph.replay()
        return g.out.clone()

    def pair(self, key, unet, controlnet, latent, t, context, cond, scale,
             part, **extras) -> torch.Tensor:
        """``unet`` on the residuals of ``controlnet`` (module docstring):
        both eagerly, or both captured or replayed. `key` is ``graph_key``
        of the call with its condition (None: eagerly); `extras` the SDXL
        inputs; `part(kind)` a context around the ControlNet's part of the
        call."""
        if key is not None:
            self._own(unet, controlnet)
        g = self._kind(key)
        if g is not None:
            g.load(_flat(latent, context, extras), t)
            g.cn.load(cond)
            g.cn.counted.add()
            g.counted.add()
            with part("replay"):
                g.cn.graph.replay()
        elif self.last == "capture":
            with part("capture"):
                g = self._capture_controlnet(controlnet, latent, t, context,
                                             cond, scale, extras)
                g.cn.graph.replay()
            self._capture_unet(g, unet, key)
        else:
            with part("eager"):
                down, mid = controlnet(latent, t, context, cond,
                                       conditioning_scale=scale, **extras)
            return unet(latent, t, context, **extras,
                        down_block_residuals=down, mid_block_residual=mid)
        g.graph.replay()
        return g.out.clone()

    def _statics(self, latent, t, context, extras) -> tuple:
        """(``_Graph`` whose static inputs hold this call's values, static
        latent, context, extras)."""
        dev = latent.device

        def static(v):
            if isinstance(v, (list, tuple)):
                return [static(r) for r in v]
            return None if v is None else torch.empty(v.shape, dtype=v.dtype,
                                                      device=dev)

        s_latent, s_context = static(latent), static(context)
        s_extras = {name: static(extras.get(name)) for name in EXTRAS}
        st = torch.empty((), dtype=torch.float32, device=dev)
        g = _Graph(_flat(s_latent, s_context, s_extras), st)
        g.load(_flat(latent, context, extras), t)
        return g, s_latent, s_context, s_extras

    def _record(self, dev, fn) -> tuple:
        """(graph, ``fn()``, ``Counted``): `fn` captured on the capture
        stream into the pool."""
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
        if self.stream is None or self.stream.device != dev:
            self.stream = torch.cuda.Stream(dev)
        current = torch.cuda.current_stream(dev)
        self.stream.wait_stream(current)
        graph = torch.cuda.CUDAGraph()

        def forward():
            graph.capture_begin(pool=self.pool)
            try:
                out = fn()
            except BaseException:
                try:
                    graph.capture_end()
                except RuntimeError:
                    pass  # the capture was already invalidated
                raise
            graph.capture_end()
            return out

        with torch.cuda.stream(self.stream):
            out, c = counted(forward)
        current.wait_stream(self.stream)
        # cuBLAS keeps a workspace for each stream it ran on: the capture
        # stream's was allocated in the pool, and would stay allocated for
        # the process. Freed, it is free pool memory that this graph uses
        # as scratch, as it uses its activations (PyTorch's own CUDA graph
        # trees do the same); the next eager product allocates the
        # default stream's anew
        torch._C._cuda_clearCublasWorkspaces()
        return graph, out, c

    def _capture(self, unet, key, latent, t, context, extras) -> _Graph:
        """Capture the forward at `key` on the capture stream, into the
        pool, with static inputs that already hold this call's values."""
        g, s_latent, s_context, s_extras = self._statics(latent, t, context,
                                                         extras)
        g.graph, g.out, g.counted = self._record(
            latent.device, lambda: unet(s_latent, g.t, s_context, **s_extras))
        self.graphs[key] = g
        return g

    def _capture_controlnet(self, controlnet, latent, t, context, cond,
                            scale, extras) -> _Graph:
        """A pair's static inputs and its ControlNet's graph (the UNet's
        comes next, ``_capture_unet``)."""
        g, s_latent, s_context, s_extras = self._statics(latent, t, context,
                                                         extras)
        dims = _broadcast(cond)
        one = _distinct(cond, dims)
        s_cond = torch.empty(one.shape, dtype=controlnet.dtype,
                             device=latent.device)
        if s_cond.dim() == 4:
            s_cond = s_cond.contiguous(memory_format=torch.channels_last)
        g.cn = _Control(s_cond, dims)
        g.cn.load(cond)
        full = s_cond.expand(cond.shape)
        g.cn.graph, g.cn.residuals, g.cn.counted = self._record(
            latent.device, lambda: controlnet(
                s_latent, g.t, s_context, full, conditioning_scale=scale,
                **{k: s_extras[k] for k in extras}))
        return g

    def _capture_unet(self, g: _Graph, unet, key) -> None:
        """The UNet's graph of a pair, on the ControlNet graph's residuals;
        keeps the pair at `key`."""
        s_latent, s_context = g.inputs[0], g.inputs[1]
        extras = {k: v for k, v in zip(EXTRAS[:2], g.inputs[2:4])
                  if v is not None}
        down, mid = g.cn.residuals
        g.graph, g.out, g.counted = self._record(
            s_latent.device, lambda: unet(
                s_latent, g.t, s_context, **extras,
                down_block_residuals=down, mid_block_residual=mid))
        self.graphs[key] = g
