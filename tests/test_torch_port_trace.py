"""The port's spans (``utils/trace.py``) and its count of UNet rows, on the
CPU with a toy bundle of seeded random weights.

With no tracer: nothing is recorded and the call sites get the shared null
span. With one: the tree of one repaint run of T = 3 (every span under one
image root, each inside its parent's interval, the estimators in each
step), the phases on ``last_metrics``' own clock reads, Σ ``unet`` rows
against the counted ``unet_view_forwards`` and the old formula, the decode
routes, and the shared clock with ``torch.profiler``'s events. With a
ControlNet: its ``controlnet`` and ``cond`` spans (the ``controlnet``
span's ``graph`` attribute), its counted rows, seconds and graph calls, and
no host array handed to torch in a local call; without one, none of them.
"""

import functools
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from toy_configs import toy_bundle_config
from torch_port_common import TORCH_TOY_RUNTIME, port_bundle_config

from elasticdiffusion_tpu_torch.core import signals
from elasticdiffusion_tpu_torch.core.pipeline import ElasticDiffusion
from elasticdiffusion_tpu_torch.models.registry import (CallClock, ModelBundle,
                                                        load_bundle)
from elasticdiffusion_tpu_torch.parallel import halo_decode as thd
from elasticdiffusion_tpu_torch.utils import trace

T, RS, H, W = 3, 1, 32, 48
PHASES = ("preamble", "denoise", "decode")
KEYS = {"steps", "views", "unet_view_forwards", "unet_graph_replays",
        "unet_graph_captures", "denoise_seconds",
        "preamble_seconds", "decode_seconds", "decode_route"}


@functools.lru_cache(maxsize=1)
def _bundle():
    return load_bundle("toy", TORCH_TOY_RUNTIME,
                       bundle_config=port_bundle_config(toy_bundle_config()),
                       device="cpu")


def _generate(steps=T, rs=RS, **kw):
    pipe = ElasticDiffusion(bundle=_bundle(), device="cpu")
    pipe.seed_everything(3)
    pipe.generate_image("a cat", height=H, width=W, num_inference_steps=steps,
                        resampling_steps=rs, return_arrays=True, **kw)
    return pipe


@pytest.fixture
def tracer():
    trace.tracer = trace.Tracer()
    try:
        yield trace.tracer
    finally:
        trace.tracer = None


@pytest.fixture(scope="module")
def traced():
    """(spans, last_metrics) of one repaint run of T steps."""
    trace.tracer = tr = trace.Tracer()
    try:
        pipe = _generate()
    finally:
        trace.tracer = None
    return tr.spans, pipe.last_metrics


@functools.lru_cache(maxsize=1)
def _canny_bundle():
    return load_bundle("toy", TORCH_TOY_RUNTIME,
                       bundle_config=port_bundle_config(toy_bundle_config()),
                       controlnet_model="canny", device="cpu")


@pytest.fixture(scope="module")
def canny_traced():
    """(spans, last_metrics) of one repaint run of 2 steps with a
    ControlNet condition."""
    pipe = ElasticDiffusion(bundle=_canny_bundle(), device="cpu")
    pipe.seed_everything(3)
    cond = (torch.rand(1, 3, 32, 32, generator=torch.Generator().manual_seed(5))
            > 0.8).float()
    trace.tracer = tr = trace.Tracer()
    try:
        pipe.generate_image("a cat", height=32, width=32, num_inference_steps=2,
                            resampling_steps=RS, return_arrays=True,
                            condition_image=cond,
                            controlnet_conditioning_scale=0.5)
    finally:
        trace.tracer = None
    return tr.spans, pipe.last_metrics


def _children(spans, parent):
    return [s for s in spans if s.parent == parent.id]


def _one(spans, name):
    found = [s for s in spans if s.name == name]
    assert len(found) == 1, (name, len(found))
    return found[0]


def test_no_tracer_records_nothing_and_keeps_the_metrics():
    assert trace.tracer is None
    assert trace.span("unet", rows=2) is trace.NULL
    assert trace.begin("preamble", 0, peak="cpu") is trace.NULL
    with trace.span("x") as s:
        s.set(a=1)
    trace.NULL.end(5, route="plain")
    pipe = _generate(steps=2)
    m = pipe.last_metrics
    assert set(m) == KEYS
    assert "unet_view_forwards_per_sec" not in m
    assert m["decode_route"] == "plain"


def test_one_image_root_and_its_phases(traced):
    spans, _ = traced
    roots = [s for s in spans if s.parent is None]
    assert [r.name for r in roots] == ["image"]
    root = roots[0]
    assert all(s.image == root.id for s in spans)
    assert all(s.t1_ns is not None for s in spans)
    assert [s.name for s in _children(spans, root)] == list(PHASES)
    assert root.attrs == {"height": H, "width": W, "steps": T, "rs": RS,
                          "views": root.attrs["views"], "B": 1}
    assert [s.name for s in _children(spans, _one(spans, "preamble"))] == \
        ["context", "schedule"]


def test_steps_hold_their_estimators(traced):
    spans, _ = traced
    steps = _children(spans, _one(spans, "denoise"))
    assert [(s.name, s.attrs) for s in steps] == [
        ("step", {"i": i, "repaint": i < T - 1}) for i in range(T)]
    for step in steps:
        kids = _children(spans, step)
        names = [k.name for k in kids]
        if step.attrs["repaint"]:
            assert names == ["direction", "local", "undo", "direction", "local"]
            assert kids[2].attrs == {"micro_steps": 1000 // T}
        else:
            assert names == ["direction", "local"]
        for d, which in zip(kids[::3], ("main", "repaint")):
            rs = RS if which == "main" else 0
            assert d.attrs == {"pass": which, "rs": rs}
            inner = _children(spans, d)
            assert [k.name for k in inner] == ["picks", "unet"]
            assert inner[0].attrs == {"n_sub": rs + 1}
            assert inner[1].attrs["rows"] == 2 * (rs + 1)
        for loc in kids[1::3]:
            assert loc.attrs["chunks"] == 1
            assert [(k.name, k.attrs["rows"]) for k in _children(spans, loc)] \
                == [("unet", loc.attrs["views"])]


def test_every_child_lies_inside_its_parent(traced):
    spans, _ = traced
    by_id = {s.id: s for s in spans}
    assert [s.id for s in spans] == list(range(len(spans)))
    for s in spans:
        assert s.t0_ns <= s.t1_ns
        if s.parent is not None:
            p = by_id[s.parent]
            assert p.t0_ns <= s.t0_ns and s.t1_ns <= p.t1_ns, (s, p)


def test_unet_rows_are_counted_and_equal_the_formula(traced):
    spans, m = traced
    denoise = _one(spans, "denoise")
    rows = sum(s.attrs["rows"] for s in spans if s.name == "unet"
               and denoise.t0_ns <= s.t0_ns <= denoise.t1_ns)
    V = m["views"]
    assert rows == m["unet_view_forwards"] \
        == T * (2 * (RS + 1) + V) + (T - 1) * (2 + V)
    unet = [s for s in spans if s.name == "unet"][0]
    assert (unet.attrs["h"], unet.attrs["w"], unet.attrs["controlnet"]) == \
        (8, 8, False)


def test_apply_unet_counts_its_rows():
    b = _bundle()
    before = b.unet_rows
    b.apply_unet(torch.zeros(3, 4, 8, 8), 500.0, torch.zeros(3, 77, 16))
    assert b.unet_rows - before == 3


def test_phases_share_the_clock_reads_of_last_metrics(traced):
    spans, m = traced
    for name in PHASES:
        s = _one(spans, name)
        assert abs((s.t1_ns - s.t0_ns) / 1e9 - m[f"{name}_seconds"]) < 1e-6
        assert "peak_bytes" not in s.attrs      # a CPU run records no peak
    assert _one(spans, "decode").attrs["route"] == m["decode_route"] == "plain"


@pytest.mark.parametrize("tiled,halo,streamed,route", [
    (False, True, False, "plain"),
    (True, False, False, "tiled"),
    (True, True, False, "halo:monolithic"),
    (True, True, True, "halo:streamed"),
])
def test_decode_route_is_the_branch_taken(tiled, halo, streamed, route,
                                          monkeypatch, tracer):
    monkeypatch.setattr(ElasticDiffusion, "use_halo_decode", halo)
    if streamed:
        monkeypatch.setattr(thd, "MAX_PX", {dt: 1 for dt in thd.MAX_PX})
    pipe = _generate(steps=1, rs=0, tiled_decoder=tiled)
    assert pipe.last_metrics["decode_route"] == route
    assert _one(tracer.spans, "decode").attrs["route"] == route


def test_halo_decode_returns_its_branch():
    b = _bundle()
    lat = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (1, 4, 16, 8)).astype(np.float32))
    img = thd.halo_decode(b, lat)
    for kw, branch in (({}, "monolithic"), ({"num_bands": 2}, "bands"),
                       ({"streamed": True}, "streamed")):
        got, name = thd.halo_decode(b, lat, return_branch=True, **kw)
        assert name == branch and got.shape == img.shape


def test_unet_spans_hold_the_profilers_events(monkeypatch, tracer):
    """The shared clock: every ``apply_unet`` range that torch.profiler
    records, and the ``aten::`` ops inside it, lie inside the matching
    ``unet`` span within 0.5 ms."""
    orig = ModelBundle.apply_unet

    def ranged(self, *a, **k):
        with record_function("test.apply_unet"):
            return orig(self, *a, **k)
    monkeypatch.setattr(ModelBundle, "apply_unet", ranged)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _generate(steps=2)
    events = prof.profiler.kineto_results.events()
    ranges = sorted((e.start_ns(), e.end_ns()) for e in events
                    if e.name() == "test.apply_unet")
    aten = [(e.start_ns(), e.end_ns()) for e in events
            if e.name().startswith("aten::")]
    unets = [s for s in tracer.spans if s.name == "unet"]
    assert len(ranges) == len(unets) > 0
    slack = 500_000
    for (r0, r1), s in zip(ranges, unets):
        inside = [(a0, a1) for a0, a1 in aten if r0 <= a0 and a1 <= r1]
        assert inside
        for a0, a1 in [(r0, r1)] + inside:
            assert s.t0_ns - slack <= a0 and a1 <= s.t1_ns + slack


def test_an_exception_ends_the_spans_left_open(tracer):
    with pytest.raises(ValueError):
        with trace.span("image"):
            trace.begin("preamble")
            raise ValueError
    image, pre = tracer.spans
    assert pre.parent == image.id and image.t1_ns == pre.t1_ns is not None
    ended = image.t1_ns
    trace.span("later").end()
    tracer.end(image, ended + 10)          # ending again changes nothing
    assert image.t1_ns == ended and tracer.spans[-1].parent is None


def test_peak_bytes_reset_at_begin_and_read_at_end(monkeypatch, tracer):
    calls = []
    monkeypatch.setattr(torch.cuda, "reset_peak_memory_stats",
                        lambda dev: calls.append(("reset", dev)))
    monkeypatch.setattr(torch.cuda, "max_memory_allocated",
                        lambda dev: calls.append(("read", dev)) or 1234)
    dev = torch.device("cuda", 0)
    with trace.span("denoise", peak=dev):
        assert calls == [("reset", dev)]
        with trace.span("step", peak="cpu"):
            pass
    assert calls == [("reset", dev), ("read", dev)]
    denoise, step = tracer.spans
    assert denoise.attrs == {"peak_bytes": 1234} and step.attrs == {}


def _controlnet_rows_are_the_unets(spans, m):
    assert m["controlnet_view_forwards"] == m["unet_view_forwards"] > 0


def _controlnet_seconds_lie_in_the_loop(spans, m):
    assert 0 < m["controlnet_device_seconds"] <= m["denoise_seconds"]


def _controlnet_spans_lie_in_unet_spans(spans, m):
    by_id = {s.id: s for s in spans}
    unets = [s for s in spans if s.name == "unet"]
    nets = [s for s in spans if s.name == "controlnet"]
    assert len(nets) == len(unets) > 0
    for s in nets:
        p = by_id[s.parent]
        assert p.name == "unet" and p.t0_ns <= s.t0_ns <= s.t1_ns <= p.t1_ns
        assert (s.attrs["rows"], s.attrs["h"], s.attrs["w"]) == \
            (p.attrs["rows"], p.attrs["h"], p.attrs["w"])
        assert s.attrs["scale"] == 0.5


def _cond_span_once_an_image_in_its_context(spans, m):
    conds = [s for s in spans if s.name == "cond"]
    contexts = [s for s in spans if s.name == "context"]
    assert len(conds) == len(contexts) > 0
    assert sorted(s.parent for s in conds) == sorted(s.id for s in contexts)
    # one image: a row of the views' condition a view
    views = max(s.attrs["views"] for s in spans if s.name == "local")
    for s in conds:
        assert s.attrs["view_rows"] == views > 0
        assert min(s.attrs[k] for k in ("h", "w", "view_h", "view_w")) > 0
    assert not {s.parent for s in spans} & {s.id for s in conds}


def _controlnet_spans_carry_the_unets_graph(spans, m):
    by_id = {s.id: s for s in spans}
    nets = [s for s in spans if s.name == "controlnet"]
    assert nets and all(s.attrs["graph"] == by_id[s.parent].attrs["graph"]
                        == "eager" for s in nets)


def _controlnet_graph_counters_read_eager_on_the_cpu(spans, m):
    assert m["controlnet_graph_replays"] == m["controlnet_graph_captures"] == 0


@pytest.mark.parametrize("check", [_controlnet_rows_are_the_unets,
                                   _controlnet_seconds_lie_in_the_loop,
                                   _controlnet_spans_lie_in_unet_spans,
                                   _cond_span_once_an_image_in_its_context,
                                   _controlnet_spans_carry_the_unets_graph,
                                   _controlnet_graph_counters_read_eager_on_the_cpu])
def test_a_controlnet_records_its_spans_and_counters(check, canny_traced):
    check(*canny_traced)


def test_a_local_call_hands_no_host_array_to_torch(monkeypatch):
    """The image's ControlNet conditions are built once, in ``_context``:
    after an image's first local call (which uploads the view plan's owner
    maps, with a ControlNet or without), no local call hands a NumPy array
    to torch, the first step of a copy from the host."""
    arrays, per_call = [], []
    from_numpy, local = torch.from_numpy, signals.compute_local_uncond_signal
    monkeypatch.setattr(torch, "from_numpy",
                        lambda a: arrays.append(a.shape) or from_numpy(a))

    def counted_local(*args, **kwargs):
        n = len(arrays)
        out = local(*args, **kwargs)
        per_call.append(len(arrays) - n)
        return out

    monkeypatch.setattr(signals, "compute_local_uncond_signal", counted_local)
    pipe = ElasticDiffusion(bundle=_canny_bundle(), device="cpu")
    pipe.seed_everything(3)
    pipe.generate_image("a cat", height=32, width=32, num_inference_steps=2,
                        resampling_steps=RS, return_arrays=True,
                        condition_image=torch.rand(1, 3, 32, 32),
                        controlnet_conditioning_scale=0.5)
    # step 0's main and repaint pass, step 1's main pass
    assert len(per_call) == 3 and per_call[1:] == [0, 0], per_call


def test_no_controlnet_records_neither_key_nor_span(traced):
    spans, m = traced
    assert not {s.name for s in spans} & {"controlnet", "cond"}
    assert set(m) == KEYS


def test_the_call_clock_times_only_inside_a_period():
    cpu, clock = torch.device("cpu"), CallClock()
    assert clock.begin(cpu) is None
    clock.end(None)
    clock.start()
    tick = clock.begin(cpu)
    time.sleep(0.01)
    clock.end(tick)
    assert 0.01 <= clock.read() < 1.0
    assert clock.begin(cpu) is None
    clock.start()
    assert clock.read() == 0.0
