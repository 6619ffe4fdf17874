"""The UNet forward's CUDA graphs (``models/unet_graphs.py``), on the CPU
with toy bundles of seeded random weights.

No graph is captured here: a CPU call has no key, so ``apply_unet`` runs
the same eager code as before and must equal ``bundle.unet(...)`` bit for
bit. What is held here is the bookkeeping the card relies on: which inputs
make a key and which do not change it, the drops (kernels, convolutions,
another UNet, a new image size) and what a reload of weights keeps, the
order of captures (with a stand-in for the capture), the kernel counts a
replay adds, the counters and the ``unet`` span's ``graph`` attribute, the
timestep's fill, and GroupNorm's counter buffers, which a graph may hold
and which are never freed. With a ControlNet beside the UNet: the pair's
key, its eager CPU calls, the order of its two captures and replays (the
UNet's graph on the ControlNet graph's residuals), its counts and its
drops; one case captures and replays a toy pair on a CUDA device, and
skips without one.
"""

import collections
import contextlib
import copy
import functools
import types

import numpy as np
import pytest
import torch

from toy_configs import toy_bundle_config
from torch_port_common import TORCH_TOY_RUNTIME, port_bundle_config

from elasticdiffusion_tpu_torch import kernels
from elasticdiffusion_tpu_torch.core.pipeline import ElasticDiffusion
from elasticdiffusion_tpu_torch.kernels import groupnorm
from elasticdiffusion_tpu_torch.kernels.conv3x3 import conv3x3
from elasticdiffusion_tpu_torch.kernels.layernorm import fused_layer_norm
from elasticdiffusion_tpu_torch.models import unet_graphs
from elasticdiffusion_tpu_torch.models.convert import load_into
from elasticdiffusion_tpu_torch.models.layers import Conv3x3
from elasticdiffusion_tpu_torch.models.registry import _fp32_convs, load_bundle
from elasticdiffusion_tpu_torch.models.unet_graphs import (Counted,
                                                           UNetGraphs,
                                                           counted,
                                                           graph_key,
                                                           input_key)
from elasticdiffusion_tpu_torch.utils import trace

H, W = 32, 48


@functools.lru_cache(maxsize=None)
def _bundle(xl: bool = False, controlnet=None):
    return load_bundle("toy", TORCH_TOY_RUNTIME,
                       bundle_config=port_bundle_config(toy_bundle_config(xl)),
                       controlnet_model=controlnet, device="cpu")


def _inputs(b, rows: int = 2, h: int = 8, w: int = 8, seed: int = 0):
    """(latent, context, SDXL extras) of a toy bundle's UNet."""
    g = torch.Generator().manual_seed(seed)
    u = b.config.unet
    lat = torch.randn(rows, u.in_channels, h, w, generator=g)
    ctx = torch.randn(rows, 77, u.cross_attention_dim, generator=g)
    kw = {}
    if b.config.is_xl:
        kw = {"added_text_embeds": torch.randn(rows, u.pooled_projection_dim,
                                               generator=g),
              "added_time_ids": torch.tensor([[64.0, 96.0, 0.0, 0.0, 64.0,
                                               96.0]]).expand(rows, 6)}
    return lat, ctx, kw


def _base():
    lat = torch.zeros(2, 4, 8, 8)
    ctx = torch.zeros(2, 77, 16)
    return lat, 500.0, ctx, {}


def _residuals(n=3, rows=2):
    return [torch.zeros(rows, 8, 8, 8) for _ in range(n)]


# each case: a change of the base call, and whether it keeps the key
KEY_CASES = {
    "values": (lambda l, t, c, kw: (l + 1, t, c - 1, kw), True),
    "timestep_value": (lambda l, t, c, kw: (l, 10.0, c, kw), True),
    "timestep_int": (lambda l, t, c, kw: (l, 981, c, kw), True),
    "timestep_numpy": (lambda l, t, c, kw: (l, np.float64(3.5), c, kw), True),
    "timestep_cpu_scalar": (lambda l, t, c, kw: (l, torch.tensor(7.0), c, kw),
                            True),
    "expanded_context": (lambda l, t, c, kw: (
        l, t, torch.zeros(1, 77, 16).expand(2, 77, 16), kw), True),
    "rows": (lambda l, t, c, kw: (torch.zeros(3, 4, 8, 8), t,
                                  torch.zeros(3, 77, 16), kw), False),
    "latent_size": (lambda l, t, c, kw: (torch.zeros(2, 4, 8, 16), t, c, kw),
                    False),
    "latent_dtype": (lambda l, t, c, kw: (l.double(), t, c, kw), False),
    "context_length": (lambda l, t, c, kw: (l, t, torch.zeros(2, 64, 16), kw),
                       False),
    "context_dtype": (lambda l, t, c, kw: (l, t, c.double(), kw), False),
    "added_text_embeds": (lambda l, t, c, kw: (
        l, t, c, {"added_text_embeds": torch.zeros(2, 24)}), False),
    "added_time_ids": (lambda l, t, c, kw: (
        l, t, c, {"added_time_ids": torch.zeros(2, 6)}), False),
    "down_residuals": (lambda l, t, c, kw: (
        l, t, c, {"down_block_residuals": _residuals()}), False),
    "mid_residual": (lambda l, t, c, kw: (
        l, t, c, {"mid_block_residual": torch.zeros(2, 16, 4, 4)}), False),
}


@pytest.mark.parametrize("case", sorted(KEY_CASES))
def test_what_the_key_holds(case):
    change, same = KEY_CASES[case]
    l, t, c, kw = _base()
    base = input_key(l, t, c, **kw)
    assert base is not None
    other = input_key(*change(l, t, c, kw)[:3], **change(l, t, c, kw)[3])
    assert other is not None
    assert (other == base) == same, case


@pytest.mark.parametrize("what", ["residual_count", "residual_shape",
                                  "residual_dtype"])
def test_each_residual_is_in_the_key(what):
    l, t, c, _ = _base()
    base = input_key(l, t, c, down_block_residuals=_residuals())
    res = {"residual_count": _residuals(4),
           "residual_shape": _residuals()[:2] + [torch.zeros(2, 8, 4, 4)],
           "residual_dtype": _residuals()[:2] + [torch.zeros(2, 8, 8, 8,
                                                             dtype=torch.float64)]}
    assert input_key(l, t, c, down_block_residuals=res[what]) != base


@pytest.mark.parametrize("t", [True, "500", torch.zeros(2),
                               torch.zeros((), device="meta")])
def test_a_timestep_that_is_not_a_number_has_no_key(t):
    l, _, c, _ = _base()
    assert input_key(l, t, c) is None


def test_an_input_on_another_device_has_no_key():
    l, t, c, _ = _base()
    assert input_key(l, t, c.to("meta")) is None
    assert input_key(l, t, c, mid_block_residual=torch.zeros(
        2, 16, 4, 4, device="meta")) is None


def test_the_matmul_flags_are_in_the_key():
    l, t, c, kw = _base()
    prev = torch.backends.cuda.matmul.allow_tf32
    base = input_key(l, t, c, **kw)
    try:
        torch.backends.cuda.matmul.allow_tf32 = not prev
        assert input_key(l, t, c, **kw) != base
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    assert input_key(l, t, c, **kw) == base


def test_no_graph_key_on_the_cpu():
    l, t, c, kw = _base()
    assert input_key(l, t, c, **kw) is not None
    assert graph_key(l, t, c, **kw) is None


@pytest.mark.parametrize("xl,controlnet", [(False, None), (True, None),
                                           (False, "canny")])
def test_cpu_calls_stay_eager_and_equal_the_module(xl, controlnet):
    b = _bundle(xl, controlnet)
    lat, ctx, kw = _inputs(b, rows=3)
    if controlnet is not None:
        cond = torch.rand(3, 3, 16, 16, generator=torch.Generator().manual_seed(1))
        down, mid = b.apply_controlnet(lat, 500.0, ctx, cond, **kw)
        kw = {**kw, "down_block_residuals": down, "mid_block_residual": mid}
    g = b.unet_graphs
    before = (g.replays, g.captures, g.eager)
    seen, graphs = set(g.seen), dict(g.graphs)
    rows = b.unet_rows
    with torch.no_grad():
        want = b.unet(lat, 500.0, ctx, **kw)
    for _ in range(3):      # a key would be captured at the second call
        got = b.apply_unet(lat, 500.0, ctx, **kw)
        assert torch.equal(got, want)
        assert b.unet_graphs.last == "eager"
    assert (g.replays, g.captures, g.eager) == (before[0], before[1],
                                                before[2] + 3)
    assert b.unet_rows - rows == 9
    assert g.seen == seen and g.graphs == graphs


@pytest.mark.parametrize("t", [500.0, 500, np.float32(500.0),
                               torch.tensor(500.0), torch.tensor([500.0] * 2)])
def test_the_timestep_fill_equals_the_copy(t):
    b = _bundle()
    lat, ctx, _ = _inputs(b)
    want = b.apply_unet(lat, torch.tensor(500.0), ctx)
    assert torch.equal(b.apply_unet(lat, t, ctx), want)


def _populate(g: UNetGraphs):
    g.seen.add("key")
    g.graphs["key"] = object()
    g.pool = object()


def _empty(g: UNetGraphs) -> bool:
    return not g.seen and not g.graphs and g.pool is None


@pytest.mark.parametrize("flip", ["set_use_kernels", "set_conv_impl"])
def test_mode_flips_drop_the_graphs(flip):
    b = _bundle()
    g = b.unet_graphs
    _populate(g)
    if flip == "set_use_kernels":
        b.set_use_kernels(b.unet.down_blocks[0].resnets[0].norm1.use_kernels)
    else:
        b.set_conv_impl(b.runtime.conv_impl)
    assert _empty(g)


def test_a_reload_of_weights_keeps_the_graphs():
    b = _bundle()
    g = UNetGraphs()
    lat, ctx, _ = _inputs(b)
    with torch.no_grad():
        g("first", b.unet, lat, 500.0, ctx)
        load_into(b.unet, b.unet.state_dict(), "toy unet")
        g("second", b.unet, lat, 500.0, ctx)
    assert g.seen == {"first", "second"}


@pytest.mark.parametrize("xl,controlnet", [(False, None), (True, None),
                                           (False, "canny")])
def test_a_reload_writes_where_a_graph_reads(xl, controlnet):
    """What lets a replay read reloaded weights: ``load_into`` writes into
    the tensors the UNet holds, and a 3x3 conv's weight is channels_last,
    so the conv kernel reads a view of it, not a re-laid copy."""
    b = _bundle(xl, controlnet)
    own = {k: (t.data_ptr(), t.stride())
           for k, t in b.unet.state_dict().items()}
    sd = {k: t + 1 for k, t in b.unet.state_dict().items()}
    old = {k: t.clone() for k, t in b.unet.state_dict().items()}
    try:
        load_into(b.unet, sd, "toy unet")
        assert {k: (t.data_ptr(), t.stride())
                for k, t in b.unet.state_dict().items()} == own
        convs = [m for m in b.unet.modules() if isinstance(m, Conv3x3)
                 and m.weight.shape[2:] == (3, 3)]
        assert convs
        for m in convs:
            hwio = m._weight_hwio()
            assert hwio.data_ptr() == m.weight.data_ptr()
            assert torch.equal(hwio, m.weight.permute(2, 3, 1, 0))
    finally:
        load_into(b.unet, old, "toy unet")


def _fake_capture(self, unet, key, latent, t, context, extras):
    """``UNetGraphs._capture`` without CUDA: the forward run once, its
    output the static one."""
    g = types.SimpleNamespace(graph=types.SimpleNamespace(replay=lambda: None),
                              out=unet(latent, t, context, **extras),
                              counted=Counted(), load=lambda flat, t: None)
    self.graphs[key] = g
    return g


@pytest.mark.parametrize("rows", [(22, 16, 2, 16), (16, 16, 2, 16),
                                  (16, 4, 2, 4), (2, 4, 16, 8)])
def test_the_largest_key_is_captured_first(monkeypatch, rows):
    """Whatever order the keys come in, the pool's first graph is its
    largest; a smaller key released for a larger one is captured again at
    its next call, at most once more, and then every call replays."""
    monkeypatch.setattr(UNetGraphs, "_capture", _fake_capture)
    b = _bundle()
    g = UNetGraphs()
    inputs = {r: _inputs(b, rows=r) for r in set(rows)}
    keys = {r: input_key(inputs[r][0], 500.0, inputs[r][1]) for r in inputs}
    kinds = []
    with torch.no_grad():
        for _ in range(4):
            for r in rows:
                lat, ctx, _ = inputs[r]
                g(keys[r], b.unet, lat, 500.0, ctx)
                kinds.append(g.last)
                sizes = [unet_graphs._size(k) for k in g.graphs]
                assert not sizes or sizes[0] == max(sizes)
    assert set(g.graphs) == set(keys.values())
    assert kinds[-len(rows):] == ["replay"] * len(rows)
    assert g.captures <= 2 * len(keys)
    assert g.seen == set(keys.values())


def test_a_smaller_key_keeps_the_pool(monkeypatch):
    monkeypatch.setattr(UNetGraphs, "_capture", _fake_capture)
    b = _bundle()
    g = UNetGraphs()
    big, small = _inputs(b, rows=4), _inputs(b, rows=2)
    with torch.no_grad():
        for lat, ctx, _ in (big, big, small):
            g(input_key(lat, 500.0, ctx), b.unet, lat, 500.0, ctx)
        pool = g.pool = object()
        first = dict(g.graphs)
        g(input_key(small[0], 500.0, small[1]), b.unet, small[0], 500.0,
          small[1])
    assert g.last == "capture" and g.pool is pool
    assert all(g.graphs[k] is v for k, v in first.items())


@pytest.mark.parametrize("log,raises", [(False, False), (True, False),
                                        (True, True)])
def test_a_replay_counts_what_its_capture_counted(log, raises):
    """``counted`` takes what the wrappers counted over a block, passes its
    log entries on to a log that is set, and ``Counted.add`` counts them
    all again, as a replay of the block runs them."""
    saved = (kernels.launch_log, conv3x3.launches, conv3x3.copies,
             fused_layer_norm.launches)
    outer = kernels.launch_log = collections.Counter() if log else None

    def block():
        conv3x3.launches += 2
        conv3x3.copies += 1
        kernels.note_launch("conv3x3", 8, 16)
        kernels.note_launch("conv3x3", 8, 16)
        if raises:
            raise ValueError("inside the block")
        return "out"

    try:
        if raises:
            with pytest.raises(ValueError):
                counted(block)
            assert kernels.launch_log is outer
            assert outer == collections.Counter({("conv3x3", 8, 16): 2})
            return
        out, c = counted(block)
        assert out == "out" and kernels.launch_log is outer
        assert c.counters == {(conv3x3, "launches"): 2,
                              (conv3x3, "copies"): 1}
        assert c.log == collections.Counter({("conv3x3", 8, 16): 2})
        if log:
            assert outer == c.log
        c.add()
        c.add()
        assert (conv3x3.launches, conv3x3.copies, fused_layer_norm.launches) \
            == (saved[1] + 6, saved[2] + 3, saved[3])
        if log:
            assert outer == collections.Counter({("conv3x3", 8, 16): 6})
    finally:
        (kernels.launch_log, conv3x3.launches, conv3x3.copies,
         fused_layer_norm.launches) = saved


def test_every_wrapper_counts_launches():
    assert all(hasattr(w, "launches") for w in kernels.wrappers().values())
    assert {"flash_attention", "fused_layer_norm", "fused_group_norm",
            "conv3x3"} <= set(kernels.wrappers())


def test_another_unet_drops_the_graphs():
    g = UNetGraphs()
    sd, xl = _bundle(), _bundle(True)
    with torch.no_grad():
        lat, ctx, _ = _inputs(sd)
        g("sd", sd.unet, lat, 500.0, ctx)
        lat, ctx, kw = _inputs(xl)
        g("xl", xl.unet, lat, 500.0, ctx, **kw)
    assert g.seen == {"xl"}


def _generate(b, height=H, width=W, prompts="a cat", view_batch_size=0,
              steps=2):
    pipe = ElasticDiffusion(bundle=b, device="cpu",
                            view_batch_size=view_batch_size)
    pipe.seed_everything(3)
    pipe.generate_image(prompts, height=height, width=width,
                        num_inference_steps=steps, resampling_steps=1,
                        return_arrays=True)
    return pipe


@pytest.mark.parametrize("change,dropped", [
    ({}, False), ({"steps": 1}, False), ({"height": 48}, True),
    ({"width": 32}, True), ({"prompts": ["a cat", "a dog"]}, True),
    ({"view_batch_size": 1}, True)])
def test_a_new_image_shape_drops_the_graphs(change, dropped):
    b = _bundle()
    _generate(b)
    _populate(b.unet_graphs)
    _generate(b, **change)
    assert _empty(b.unet_graphs) == dropped
    b.unet_graphs.drop()


def test_cpu_metrics_and_spans_read_eager():
    b = _bundle()
    trace.tracer = tr = trace.Tracer()
    try:
        pipe = _generate(b)
    finally:
        trace.tracer = None
    m = pipe.last_metrics
    assert m["unet_graph_replays"] == 0 and m["unet_graph_captures"] == 0
    unets = [s for s in tr.spans if s.name == "unet"]
    assert unets and all(s.attrs["graph"] == "eager" for s in unets)
    assert sum(s.attrs["rows"] for s in unets) == m["unet_view_forwards"]


def test_groupnorm_keeps_outgrown_counter_buffers():
    dev = torch.device("cpu")
    first = groupnorm._counter(dev, 1)
    assert groupnorm._counter(dev, first.numel()) is first
    bigger = groupnorm._counter(dev, first.numel() + 1)
    assert bigger is not first and bigger.numel() > first.numel()
    assert any(buf is first for buf in groupnorm._outgrown)
    assert not bigger.any()


def test_module_names_the_inputs_of_the_forward():
    import inspect

    from elasticdiffusion_tpu_torch.models.unet import UNet2DCondition
    params = list(inspect.signature(UNet2DCondition.forward).parameters)
    assert tuple(params[4:]) == unet_graphs.EXTRAS


# ---------------------------------------------------------------------------
# a ControlNet beside the UNet: the pair's key, path and graphs
# ---------------------------------------------------------------------------

def _cond(rows=2, h=16, w=16, seed=1):
    return torch.rand(rows, 3, h, w, generator=torch.Generator().manual_seed(seed))


# each case: a change of the base call's condition and scale, and whether
# it keeps the key
PAIR_KEY_CASES = {
    "values": (lambda c, s: (c + 1, s), True),
    "scale_int": (lambda c, s: (c, 1), False),
    "scale": (lambda c, s: (c, 0.25), False),
    "shape": (lambda c, s: (torch.zeros(2, 3, 16, 32), s), False),
    "dtype": (lambda c, s: (c.double(), s), False),
    "broadcast": (lambda c, s: (c[:1].expand(2, 3, 16, 16), s), False),
}


@pytest.mark.parametrize("case", sorted(PAIR_KEY_CASES))
def test_a_pair_key_holds_the_condition_and_scale(case):
    l, t, c, kw = _base()
    plain = input_key(l, t, c, **kw)
    base = input_key(l, t, c, controlnet_cond=_cond(), conditioning_scale=0.5,
                     **kw)
    # a call without a condition keeps today's key; a pair's adds one part
    assert input_key(l, t, c, controlnet_cond=None, conditioning_scale=0.5,
                     **kw) == plain
    assert base[:-1] == plain and base[-1][0] == "controlnet"
    change, same = PAIR_KEY_CASES[case]
    cond, scale = change(_cond(), 0.5)
    other = input_key(l, t, c, controlnet_cond=cond, conditioning_scale=scale,
                      **kw)
    assert other is not None and (other == base) == same, case


@pytest.mark.parametrize("how", ["scale_tensor", "cond_device"])
def test_a_pair_without_a_number_or_device_has_no_key(how):
    l, t, c, _ = _base()
    cond, scale = _cond(), 0.5
    if how == "scale_tensor":
        scale = torch.tensor([0.5, 0.5])
    else:
        cond = cond.to("meta")
    assert input_key(l, t, c, controlnet_cond=cond,
                     conditioning_scale=scale) is None


@pytest.mark.parametrize("xl", [False, True])
def test_cpu_pair_calls_stay_eager_and_equal_the_modules(xl):
    b = _bundle(xl, "canny")
    lat, ctx, kw = _inputs(b, rows=3)
    cond = _cond(3)
    with torch.no_grad():
        down, mid = b.controlnet(lat, 500.0, ctx, cond, conditioning_scale=0.7,
                                 **kw)
        want = b.unet(lat, 500.0, ctx, down_block_residuals=down,
                      mid_block_residual=mid, **kw)
    g = b.unet_graphs
    before = (g.eager, b.controlnet_graph_eager, b.controlnet_rows)
    for _ in range(3):
        got = b.apply_unet(lat, 500.0, ctx, controlnet_cond=cond,
                           conditioning_scale=0.7, **kw)
        assert torch.equal(got, want) and g.last == "eager"
    assert (g.eager, b.controlnet_graph_eager, b.controlnet_rows) == (
        before[0] + 3, before[1] + 3, before[2] + 9)
    assert not g.graphs
    with pytest.raises(ValueError, match="own residuals"):
        b.apply_unet(lat, 500.0, ctx, controlnet_cond=cond,
                     mid_block_residual=mid, **kw)


class _FakeGraph:
    def __init__(self, name, log):
        self.name, self.log = name, log

    def replay(self):
        self.log.append(self.name)


def _fake_record(log, counts):
    """``UNetGraphs._record`` without CUDA: the block run once (its output
    the static one), a graph whose replay is logged, and `counts` as what
    its capture counted (the ControlNet's first, the UNet's second)."""
    def record(self, dev, fn):
        out = fn()
        name = "controlnet" if isinstance(out, tuple) else "unet"
        log.append(f"capture {name}")
        return _FakeGraph(name, log), out, Counted(
            {(conv3x3, "launches"): counts[name]})
    return record


def _pair_call(g, b, inputs, parts=None):
    lat, ctx, kw, cond = inputs
    key = input_key(lat, 500.0, ctx, controlnet_cond=cond,
                    conditioning_scale=0.5, **kw)
    part = lambda kind: (parts.append(kind), contextlib.nullcontext())[1] \
        if parts is not None else contextlib.nullcontext()
    with torch.no_grad():
        return g.pair(key, b.unet, b.controlnet, lat, 500.0, ctx, cond, 0.5,
                      part, **kw)


@pytest.mark.parametrize("broadcast", [False, True])
def test_a_pair_is_captured_at_the_second_sight_controlnet_first(
        monkeypatch, broadcast):
    """First sight eager, second captures the ControlNet, then the UNet
    on the ControlNet graph's residuals (the very tensors), and replays
    both; later sights load the inputs and replay the ControlNet, then the
    UNet. A broadcast condition keeps one row. Every call equals the
    eager pair."""
    log = []
    monkeypatch.setattr(UNetGraphs, "_record",
                        _fake_record(log, {"controlnet": 3, "unet": 5}))
    b = _bundle(True, "canny")
    lat, ctx, kw = _inputs(b, rows=2)
    cond = _cond(1).expand(2, 3, 16, 16) if broadcast else _cond(2)
    seen = []
    hook = b.unet.register_forward_pre_hook(
        lambda m, a, k: seen.append(k.get("down_block_residuals")),
        with_kwargs=True)
    g, parts = UNetGraphs(), []
    try:
        outs = [_pair_call(g, b, (lat, ctx, kw, cond), parts) for _ in range(3)]
    finally:
        hook.remove()
    assert parts == ["eager", "capture", "replay"]
    assert log == ["capture controlnet", "controlnet", "capture unet", "unet",
                   "controlnet", "unet"]
    assert (g.eager, g.captures, g.replays) == (1, 1, 1)
    pair = next(iter(g.graphs.values()))
    assert seen[1] is pair.cn.residuals[0]   # written in place, no copy
    assert all(v is None for v in pair.inputs[4:])
    assert pair.cn.cond.shape[0] == (1 if broadcast else 2)
    assert all(torch.equal(o, outs[0]) for o in outs[1:])


def test_a_pair_replay_counts_what_its_captures_counted(monkeypatch):
    monkeypatch.setattr(UNetGraphs, "_record",
                        _fake_record([], {"controlnet": 3, "unet": 5}))
    b = _bundle(False, "canny")
    lat, ctx, kw = _inputs(b, rows=2)
    g = UNetGraphs()
    saved = conv3x3.launches
    try:
        for _ in range(2):
            _pair_call(g, b, (lat, ctx, kw, _cond()))
        n = conv3x3.launches
        _pair_call(g, b, (lat, ctx, kw, _cond()))
        assert g.last == "replay" and conv3x3.launches - n == 8
    finally:
        conv3x3.launches = saved


def _realloc(module, name):
    w = module.get_submodule(name).weight
    w.data = w.data.clone()


@pytest.mark.parametrize("change,dropped", [
    ("nothing", False), ("reload_in_place", False), ("another_controlnet", True),
    ("controlnet_first_weight", True), ("controlnet_last_weight", True),
    ("set_use_kernels", True), ("set_conv_impl", True), ("new_image", True)])
def test_what_drops_a_pairs_graphs(monkeypatch, change, dropped):
    monkeypatch.setattr(UNetGraphs, "_record",
                        _fake_record([], {"controlnet": 0, "unet": 0}))
    b = load_bundle("toy", TORCH_TOY_RUNTIME,
                    bundle_config=port_bundle_config(toy_bundle_config(False)),
                    controlnet_model="canny", device="cpu")
    lat, ctx, kw = _inputs(b, rows=2)
    inputs = (lat, ctx, kw, _cond())
    g = b.unet_graphs
    for _ in range(2):
        _pair_call(g, b, inputs)
    assert len(g.graphs) == 1
    cn = b.controlnet
    if change == "reload_in_place":
        load_into(cn, cn.state_dict(), "toy controlnet")
    elif change == "another_controlnet":
        b.controlnet = copy.deepcopy(cn)
    elif change == "controlnet_first_weight":
        _realloc(cn, "conv_in")
    elif change == "controlnet_last_weight":
        _realloc(cn, "controlnet_mid_block")
    elif change == "set_use_kernels":
        b.set_use_kernels(b.unet.down_blocks[0].resnets[0].norm1.use_kernels)
    elif change == "set_conv_impl":
        b.set_conv_impl(b.runtime.conv_impl)
    elif change == "new_image":
        g.for_image(("another",))
    _pair_call(g, b, inputs)
    assert g.last == ("eager" if dropped else "replay")
    assert (len(g.graphs) == 0) == dropped


@pytest.mark.chip
def test_a_pair_replays_to_the_bit_on_the_card():
    """On a CUDA device: the pair through ``apply_unet`` runs eagerly,
    captures, replays, and every output equals the modules' eager forward
    bit for bit, at a second timestep and condition too; the UNet graph
    reads the ControlNet graph's residuals where they lie."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: a CUDA graph is captured and replayed")
    b = load_bundle("toy", TORCH_TOY_RUNTIME,
                    bundle_config=port_bundle_config(toy_bundle_config(True)),
                    controlnet_model="canny", device="cuda")
    lat, ctx, kw = (v.cuda() if torch.is_tensor(v) else
                    {k: x.cuda() for k, x in v.items()} for v in _inputs(b))
    seen = []
    hook = b.unet.register_forward_pre_hook(
        lambda m, a, k: seen.append([r.data_ptr() for r in
                                     k["down_block_residuals"]]),
        with_kwargs=True)
    try:
        for t, cond in ((500.0, _cond().cuda()), (500.0, _cond().cuda()),
                        (500.0, _cond(seed=2).cuda()), (261.0, _cond().cuda())):
            got = b.apply_unet(lat, t, ctx, controlnet_cond=cond,
                               conditioning_scale=0.5, **kw)
            # the flags apply_unet sets around the forwards: fp32 convs
            # without TF32
            with torch.no_grad(), _fp32_convs():
                down, mid = b.controlnet(lat, t, ctx, cond,
                                         conditioning_scale=0.5, **kw)
                want = b.unet(lat, t, ctx, down_block_residuals=down,
                              mid_block_residual=mid, **kw)
            assert torch.equal(got, want), (t, b.unet_graphs.last)
    finally:
        hook.remove()
    g = b.unet_graphs
    assert (g.eager, g.captures, g.replays) == (1, 1, 2)
    pair = next(iter(g.graphs.values()))
    # the UNet forwards: each call's, then its reference's; a replay runs
    # none, so the capture's is the third
    assert len(seen) == 6
    assert seen[2] == [r.data_ptr() for r in pair.cn.residuals[0]]
