"""Each estimator of the port's core/signals.py against the JAX package on
the toy SD bundle, with shared weights and injected picks and noise. fp32 on
the CPU. The bar is 1e-4: one to three toy UNet forwards deep, each within
~5e-6 of its twin (tests/test_torch_port_models.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elasticdiffusion_tpu.configs import ViewConfig as JViewConfig
from elasticdiffusion_tpu.core import background as jbg
from elasticdiffusion_tpu.core import signals as jsig
from elasticdiffusion_tpu.ops.resample import build_resample_plan as j_resample_plan
from elasticdiffusion_tpu.ops.views import build_view_plan as j_view_plan
from elasticdiffusion_tpu.sched.ddim import DDIMScheduler as JDDIM

from elasticdiffusion_tpu_torch.configs import ViewConfig as TViewConfig
from elasticdiffusion_tpu_torch.core import background as tbg
from elasticdiffusion_tpu_torch.core import signals as tsig
from elasticdiffusion_tpu_torch.ops.resample import build_resample_plan as t_resample_plan
from elasticdiffusion_tpu_torch.ops.views import build_view_plan as t_view_plan
from elasticdiffusion_tpu_torch.sched.ddim import DDIMScheduler as TDDIM
from torch_port_common import max_abs, t2n, toy_bundles

TOL = 1e-4
H, W, DH, DW = 16, 24, 5, 8   # latent, and a downsample that needs padding


def _setup(seed=0):
    jb, tb = toy_bundles()
    rng = np.random.default_rng(seed)
    lat = rng.standard_normal((1, 4, H, W)).astype(np.float32)
    jtext = [np.asarray(jb.encode_text(jb.tokenizers[0]([p]), 0)[0])
             for p in ("", "a photo of a cat")]
    text_cfg = np.concatenate(jtext).astype(np.float32)
    return jb, tb, rng, lat, text_cfg


def _tables(rng, spec):
    return {s: rng.standard_normal((4,) + hw).astype(np.float32)
            for s, hw in spec.side_shapes().items()}


def _j(d):
    return {k: jnp.asarray(v) for k, v in d.items()}


def _t(d):
    return {k: torch.from_numpy(v) for k, v in d.items()}


def test_unet_step_pads_and_crops():
    jb, tb, rng, _, text_cfg = _setup()
    x = rng.standard_normal((2, 4, DH, DW)).astype(np.float32)
    jspec, tspec = jbg.PadSpec(DH, DW, 8, 8), tbg.PadSpec(DH, DW, 8, 8)
    bgs = _tables(rng, jspec)
    want = jsig.unet_step(jb, jnp.asarray(x), jnp.float32(401.0),
                          jnp.asarray(text_cfg), jspec, _j(bgs))
    got = tsig.unet_step(tb, torch.from_numpy(x), 401.0,
                         torch.from_numpy(text_cfg), tspec, _t(bgs))
    assert got.shape == (2, 4, DH, DW)
    assert max_abs(t2n(got), np.asarray(want)) < TOL


def test_obtain_latent_direction():
    jb, tb, rng, _, text_cfg = _setup()
    x = rng.standard_normal((1, 4, 8, 8)).astype(np.float32)
    jspec, tspec = jbg.PadSpec(8, 8, 8, 8), tbg.PadSpec(8, 8, 8, 8)
    want = jsig.obtain_latent_direction(jb, jnp.asarray(x), jnp.float32(801.0),
                                        jnp.asarray(text_cfg), jspec, {})
    got = tsig.obtain_latent_direction(tb, torch.from_numpy(x), 801.0,
                                       torch.from_numpy(text_cfg), tspec, {})
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        assert max_abs(t2n(g), np.asarray(w)) < TOL


@pytest.mark.parametrize("rs", [0, 2])
def test_approximate_latent_direction_with_injected_picks(rs):
    jb, tb, rng, lat, text_cfg = _setup(rs)
    jplan, tplan = j_resample_plan(H, W, DH, DW), t_resample_plan(H, W, DH, DW)
    jspec = jbg.PadSpec(jplan.out_h, jplan.out_w, 8, 8)
    tspec = tbg.PadSpec(tplan.out_h, tplan.out_w, 8, 8)
    bgs = _tables(rng, jspec)
    picks = rng.integers(0, 4, (rs + 1, jplan.num_blocks)).astype(np.int32)
    picks[0] = 0
    want = jsig.approximate_latent_direction(
        jb, jnp.asarray(lat), jax.random.PRNGKey(0), jnp.float32(601.0),
        jnp.asarray(text_cfg), jplan, jspec, _j(bgs), rs, 0.7,
        scripted_picks=jnp.asarray(picks))
    got = tsig.approximate_latent_direction(
        tb, torch.from_numpy(lat), torch.Generator().manual_seed(0), 601.0,
        torch.from_numpy(text_cfg), tplan, tspec, _t(bgs), rs, 0.7,
        scripted_picks=torch.from_numpy(picks))
    assert got._fields == want._fields
    for name, g, w in zip(got._fields, got, want):
        assert max_abs(t2n(g), np.asarray(w)) < TOL, name


@pytest.mark.parametrize("view_batch_size", [0, 2, 4])
def test_compute_local_uncond_signal_ragged_chunks(view_batch_size):
    """V = 9 views: chunks of 4 leave a ragged last chunk of 1; the JAX
    package runs the whole batch there. The numbers are the same."""
    jb, tb, rng, _, text_cfg = _setup()
    h, w = 12, 12
    lat = rng.standard_normal((1, 4, h, w)).astype(np.float32)
    jplan = j_view_plan(h, w, JViewConfig.from_sample_size(8))
    tplan = t_view_plan(h, w, TViewConfig.from_sample_size(8))
    assert tplan.num_views == 9
    jspec, tspec = jbg.PadSpec(*jplan.out_shape, 8, 8), tbg.PadSpec(*tplan.out_shape, 8, 8)
    uncond = text_cfg[:1]
    want = jsig.compute_local_uncond_signal(
        jb, jnp.asarray(lat), jnp.float32(601.0), jnp.asarray(uncond), jplan,
        jspec, {}, view_batch_size=0)
    got = tsig.compute_local_uncond_signal(
        tb, torch.from_numpy(lat), 601.0, torch.from_numpy(uncond), tplan,
        tspec, {}, view_batch_size=view_batch_size)
    assert got.shape == (1, 4, h, w) and got.dtype == torch.float32
    assert max_abs(t2n(got), np.asarray(want)) < TOL


def test_reduced_resolution_guidance():
    rng = np.random.default_rng(5)
    x0 = rng.standard_normal((1, 4, H, W)).astype(np.float32)
    low = [rng.standard_normal((1, 4, DH, DW)).astype(np.float32) for _ in range(3)]
    js, ts = JDDIM(), TDDIM()
    jc = js.coeff_tables(js.set_timesteps(4))[1]
    tc = ts.coeff_tables(ts.set_timesteps(4))[1]
    want = jsig.reduced_resolution_guidance(
        jnp.asarray(x0), *map(jnp.asarray, low), 7.5, 1000.0, jnp.asarray(jc))
    got = tsig.reduced_resolution_guidance(
        torch.from_numpy(x0), *map(torch.from_numpy, low), 7.5, 1000.0, tc)
    for g, w in zip(got, want):
        assert max_abs(t2n(g), np.asarray(w)) < 1e-5


def test_undo_step_with_injected_noise():
    rng = np.random.default_rng(6)
    x = rng.standard_normal((1, 4, 6, 6)).astype(np.float32)
    js, ts = JDDIM(), TDDIM()
    jst, tst = js.set_timesteps(100), ts.set_timesteps(100)   # 10 micro-steps
    ja = js.undo_step_coeffs(jst, int(jst.timesteps[3]))
    ta = ts.undo_step_coeffs(tst, int(tst.timesteps[3]))
    noise = rng.standard_normal((len(ja[0]),) + x.shape).astype(np.float32)
    want = jsig.undo_step(jnp.asarray(x), jax.random.PRNGKey(0),
                          jnp.asarray(ja[0]), jnp.asarray(ja[1]),
                          scripted=jnp.asarray(noise))
    got = tsig.undo_step(torch.from_numpy(x), torch.Generator().manual_seed(0),
                         ta[0], ta[1], scripted=torch.from_numpy(noise))
    assert max_abs(t2n(got), np.asarray(want)) < 1e-5
    # without injected noise: fresh draws from the explicit generator
    a = tsig.undo_step(torch.from_numpy(x), torch.Generator().manual_seed(1), ta[0], ta[1])
    b = tsig.undo_step(torch.from_numpy(x), torch.Generator().manual_seed(1), ta[0], ta[1])
    assert torch.equal(a, b) and not torch.equal(a, got)


def test_resolve_resample_picks_chain():
    """Substep 0 is the top-left pick; a block's first four picks are all
    different when drop_p = 0 (the exclude mask); drop_p = 1 keeps the
    previous pick; scripted picks pass through."""
    gen = torch.Generator().manual_seed(0)
    picks = tsig.resolve_resample_picks(gen, 4, 50, 0.0)
    assert picks.shape == (4, 50) and (picks[0] == 0).all()
    assert (picks.sort(dim=0).values == torch.arange(4)[:, None]).all()
    kept = tsig.resolve_resample_picks(gen, 3, 50, 1.0)
    assert (kept == 0).all()
    scripted = np.arange(12).reshape(3, 4) % 4
    out = tsig.resolve_resample_picks(gen, 2, 4, 0.7, scripted_picks=scripted)
    np.testing.assert_array_equal(t2n(out), scripted[:2])


def test_background_table_shapes_and_determinism():
    """The port draws its own backgrounds (other numbers than jax.random);
    what must hold is shape, dtype, finiteness, and that one (seed, side, t)
    gives one table whatever the order of the calls."""
    _, tb = toy_bundles()
    ts = TDDIM()
    st = ts.set_timesteps(3)
    spec = tbg.PadSpec(5, 6, 8, 8)
    a = tbg.make_background_table(tb, st.timesteps, spec, 11, ts)
    b = tbg.make_background_table(tb, st.timesteps[::-1], spec, 11, ts)
    c = tbg.make_background_table(tb, st.timesteps, spec, 12, ts)
    assert set(a) == set(spec.side_shapes())
    for side, hw in spec.side_shapes().items():
        assert a[side].shape == (3, 4) + hw and a[side].dtype == torch.float32
        assert torch.isfinite(a[side]).all()
        assert torch.equal(a[side], b[side].flip(0))
        assert not torch.equal(a[side], c[side])
