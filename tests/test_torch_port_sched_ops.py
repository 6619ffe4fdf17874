"""Configs, schedules and geometry ops of the port against the JAX package:
numpy tables and plans array-equal, gathers and scatters equal under the
same picks."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elasticdiffusion_tpu import configs as jcfg
from elasticdiffusion_tpu.core import background as jbg
from elasticdiffusion_tpu.ops import resample as jrs
from elasticdiffusion_tpu.ops import resize as jrz
from elasticdiffusion_tpu.ops import views as jvw
from elasticdiffusion_tpu.sched import ddim as jddim
from elasticdiffusion_tpu.sched import weight_schedulers as jws

from elasticdiffusion_tpu_torch import configs as tcfg
from elasticdiffusion_tpu_torch.core import background as tbg
from elasticdiffusion_tpu_torch.ops import resample as trs
from elasticdiffusion_tpu_torch.ops import resize as trz
from elasticdiffusion_tpu_torch.ops import views as tvw
from elasticdiffusion_tpu_torch.sched import ddim as tddim
from elasticdiffusion_tpu_torch.sched import weight_schedulers as tws
from torch_port_common import t2n


def _same_fields(a, b):
    assert not isinstance(a, type) and not isinstance(b, type)  # instances
    for f in dataclasses.fields(b):
        va, vb = getattr(a, f.name), getattr(b, f.name)
        if dataclasses.is_dataclass(vb):
            _same_fields(va, vb)
        elif isinstance(vb, tuple) and vb and dataclasses.is_dataclass(vb[0]):
            assert len(va) == len(vb)
            for x, y in zip(va, vb):
                _same_fields(x, y)
        else:
            assert va == vb, f.name


@pytest.mark.parametrize("version", ["1.4", "1.5", "2.0", "2.1", "XL1.0",
                                     "some/custom-key"])
def test_bundle_configs_equal_in_value(version):
    _same_fields(jcfg.get_bundle_config(version),
                 tcfg.get_bundle_config(version))


def test_small_configs_equal_and_runtime_is_cut():
    _same_fields(jcfg.DDIMConfig(), tcfg.DDIMConfig())
    _same_fields(jcfg.GenerationConfig(), tcfg.GenerationConfig())
    _same_fields(jcfg.ViewConfig.from_sample_size(64),
                 tcfg.ViewConfig.from_sample_size(64))
    assert tcfg.MODEL_KEYS == jcfg.MODEL_KEYS
    names = {f.name for f in dataclasses.fields(tcfg.RuntimeConfig)}
    assert names == {"param_dtype", "compute_dtype", "accum_dtype",
                     "vae_decode_fp32", "use_kernels", "view_batch_size"}
    assert tcfg.RuntimeConfig().compute_dtype == torch.bfloat16
    with pytest.raises(ValueError):
        tcfg.RuntimeConfig(use_kernels="maybe")


@pytest.mark.parametrize("steps", [1, 2, 4, 50])
def test_ddim_tables_equal(steps):
    js, ts = jddim.DDIMScheduler(), tddim.DDIMScheduler()
    jst, tst = js.set_timesteps(steps), ts.set_timesteps(steps)
    np.testing.assert_array_equal(jst.timesteps, tst.timesteps)
    np.testing.assert_array_equal(js.betas, ts.betas)
    np.testing.assert_array_equal(js.alphas_cumprod, ts.alphas_cumprod)
    np.testing.assert_array_equal(js.coeff_tables(jst), ts.coeff_tables(tst))
    for t in jst.timesteps:
        assert js.add_noise_coeffs(int(t)) == ts.add_noise_coeffs(int(t))
    for i in range(steps - 1):
        a = js.undo_step_coeffs(jst, int(jst.timesteps[i + 1]))
        b = ts.undo_step_coeffs(tst, int(tst.timesteps[i + 1]))
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])


def test_ddim_step_and_add_noise_match():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 4, 6, 6)).astype(np.float32)
    e = rng.standard_normal((2, 4, 6, 6)).astype(np.float32)
    js, ts = jddim.DDIMScheduler(), tddim.DDIMScheduler()
    jst, tst = js.set_timesteps(4), ts.set_timesteps(4)
    jp, jx0 = js.step(jst, jnp.asarray(e), 1, jnp.asarray(x))
    tp, tx0 = ts.step_from_coeffs(torch.from_numpy(e), torch.from_numpy(x),
                                  ts.coeff_tables(tst)[1])
    # the same fp32 expression on both sides
    np.testing.assert_allclose(t2n(tp), np.asarray(jp), atol=1e-6)
    np.testing.assert_allclose(t2n(tx0), np.asarray(jx0), atol=1e-6)
    a, b = ts.add_noise_coeffs(501)
    np.testing.assert_allclose(
        a * x + b * e,
        np.asarray(js.add_noise(jnp.asarray(x), jnp.asarray(e), 501)), atol=1e-6)


@pytest.mark.parametrize("name", ["cosine", "linear", "const"])
def test_rrg_tables_equal(name):
    for steps, stop in ((4, 0.2), (50, 0.2), (2, 0.0)):
        a = jws.rrg_weight_table(jws.make_rrg_scheduler(name, steps, stop, 1000.0, 3.0), steps)
        b = tws.rrg_weight_table(tws.make_rrg_scheduler(name, steps, stop, 1000.0, 3.0), steps)
        np.testing.assert_array_equal(a, b)
    sched = tws.make_rrg_scheduler(tws.CosineScheduler, 10, 0.2, 1000.0, 3.0)
    assert isinstance(sched, tws.CosineScheduler) and sched(9) == 0


GEOMETRIES = [(8, 12, 5, 8), (12, 12, 8, 8), (16, 24, 8, 12), (64, 96, 42, 64),
              (96, 96, 64, 64)]


@pytest.mark.parametrize("H,W,h,w", GEOMETRIES)
def test_resample_plan_and_gather_equal(H, W, h, w):
    jp, tp = jrs.build_resample_plan(H, W, h, w), trs.build_resample_plan(H, W, h, w)
    for f in ("row_src", "col_src", "row_mask_of", "col_mask_of"):
        np.testing.assert_array_equal(getattr(jp, f), getattr(tp, f))
    assert (jp.out_h, jp.out_w) == (tp.out_h, tp.out_w)
    rng = np.random.default_rng(H * 100 + W)
    lat = rng.standard_normal((2, 4, H, W)).astype(np.float32)
    for _ in range(2):
        pick = rng.integers(0, 4, jp.num_blocks).astype(np.int32)
        jd, jm = jrs.apply_resample(jnp.asarray(lat), jp, jnp.asarray(pick))
        td, tm = trs.apply_resample(torch.from_numpy(lat), tp, torch.from_numpy(pick))
        np.testing.assert_array_equal(np.asarray(jd), t2n(td))
        np.testing.assert_array_equal(np.asarray(jm), t2n(tm))


@pytest.mark.parametrize("H,W,h,w", GEOMETRIES)
def test_view_plan_gather_and_scatter_equal(H, W, h, w):
    sample = 8 if H < 64 else 64
    jp = jvw.build_view_plan(H, W, jcfg.ViewConfig.from_sample_size(sample))
    tp = tvw.build_view_plan(H, W, tcfg.ViewConfig.from_sample_size(sample))
    assert jp.views == tp.views
    for f in ("rows", "cols", "margins", "owner_view", "owner_y", "owner_x"):
        np.testing.assert_array_equal(getattr(jp, f), getattr(tp, f))
    rng = np.random.default_rng(7)
    lat = rng.standard_normal((2, 4, H, W)).astype(np.float32)
    jg = np.asarray(jvw.gather_views(jnp.asarray(lat), jp))
    tg = tvw.gather_views(torch.from_numpy(lat), tp)
    np.testing.assert_array_equal(jg, t2n(tg))
    preds = rng.standard_normal(jg.shape).astype(np.float32)
    np.testing.assert_array_equal(
        np.asarray(jvw.scatter_first_writer(jnp.asarray(preds), jp)),
        t2n(tvw.scatter_first_writer(torch.from_numpy(preds), tp)))


def test_first_writer_wins():
    """The lowest view index that covers a pixel owns it."""
    plan = tvw.build_view_plan(12, 12, tcfg.ViewConfig.from_sample_size(8))
    V = plan.num_views
    oh, ow = plan.out_shape
    preds = torch.arange(V, dtype=torch.float32)[:, None, None, None, None] \
        .expand(V, 1, 1, oh, ow)
    out = tvw.scatter_first_writer(preds, plan)[0, 0]
    np.testing.assert_array_equal(t2n(out), plan.owner_view.astype(np.float32))
    for v, (a, b, c, d) in enumerate(plan.views):
        assert (plan.owner_view[a:b, c:d] <= v).all()


def test_fill_in_later_substeps_overwrite():
    rng = np.random.default_rng(1)
    tgt = np.zeros((1, 2, 8, 8), np.float32)
    filled = np.zeros((8, 8), bool)
    d1 = rng.standard_normal((1, 2, 4, 4)).astype(np.float32)
    d2 = rng.standard_normal((1, 2, 4, 4)).astype(np.float32)
    m1 = rng.random((8, 8)) < 0.5
    m2 = rng.random((8, 8)) < 0.5
    jt, jf = jrs.fill_in(jnp.asarray(tgt), jnp.asarray(filled), jnp.asarray(d1), jnp.asarray(m1), False)
    jt, jf = jrs.fill_in(jt, jf, jnp.asarray(d2), jnp.asarray(m2), True)
    tt, tf = trs.fill_in(torch.from_numpy(tgt), torch.from_numpy(filled), torch.from_numpy(d1), torch.from_numpy(m1), False)
    tt, tf = trs.fill_in(tt, tf, torch.from_numpy(d2), torch.from_numpy(m2), True)
    np.testing.assert_array_equal(np.asarray(jt), t2n(tt))
    np.testing.assert_array_equal(np.asarray(jf), t2n(tf))
    up2 = t2n(trz.nearest_resize(torch.from_numpy(d2), (8, 8)))
    np.testing.assert_array_equal(t2n(tt)[..., m2], up2[..., m2])


@pytest.mark.parametrize("bottom,right", [(False, False), (True, False), (False, True), (True, True)])
def test_nearest_resize_equal(bottom, right):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((1, 3, 7, 12)).astype(np.float32)
    for size in ((14, 24), (5, 9), (7, 12), (3, 30)):
        np.testing.assert_array_equal(
            np.asarray(jrz.nearest_resize(jnp.asarray(x), size, bottom, right)),
            t2n(trz.nearest_resize(torch.from_numpy(x), size, bottom, right)))


@pytest.mark.parametrize("hw", [(768, 768), (512, 768), (1024, 2048), (512, 512), (520, 1000)])
def test_get_downsample_size_equal(hw):
    assert jrs.get_downsample_size(*hw, 512) == trs.get_downsample_size(*hw, 512)


def test_pick_chain_helpers():
    """sample_pick_indices avoids excluded entries, falls back on full rows;
    mix_with_prev keeps or replaces; update_exclude_mask marks out of place."""
    gen = torch.Generator().manual_seed(0)
    excl = torch.zeros(64, 4, dtype=torch.bool)
    excl[:, 1] = True
    excl[:8] = True
    pick = trs.sample_pick_indices(gen, excl, 64)
    assert ((pick >= 0) & (pick < 4)).all() and (pick[8:] != 1).all()
    assert trs.sample_pick_indices(gen, None, 64).shape == (64,)
    prev = torch.full((64,), 3)
    assert (trs.mix_with_prev(gen, pick, prev, 1.0) == 3).all()
    assert (trs.mix_with_prev(gen, pick, prev, 0.0) == pick).all()
    before = excl.clone()
    new = trs.update_exclude_mask(excl, pick)
    assert new[torch.arange(64), pick].all()
    assert torch.equal(excl, before)  # out of place


@pytest.mark.parametrize("shape", [(5, 8, 8, 8), (8, 5, 8, 8), (8, 8, 8, 8), (3, 4, 8, 10)])
def test_pad_spec_pad_and_crop_equal(shape):
    js, ts = jbg.PadSpec(*shape), tbg.PadSpec(*shape)
    assert js.pads == ts.pads and js.out_shape == ts.out_shape
    assert js.side_shapes() == ts.side_shapes()
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 4, shape[0], shape[1])).astype(np.float32)
    bgs = {s: rng.standard_normal((4,) + hw).astype(np.float32)
           for s, hw in js.side_shapes().items()}
    jp = jbg.pad_with_background(jnp.asarray(x), js, {s: jnp.asarray(v) for s, v in bgs.items()})
    tp = tbg.pad_with_background(torch.from_numpy(x), ts, {s: torch.from_numpy(v) for s, v in bgs.items()})
    np.testing.assert_array_equal(np.asarray(jp), t2n(tp))
    np.testing.assert_array_equal(t2n(tbg.crop_from_padding(tp, ts)), x)
    assert tbg.string_to_number("2_1_3_8") == jbg.string_to_number("2_1_3_8")
