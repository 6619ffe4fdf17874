"""The JAX package's remaining public functions, held to the port's.

The pixel-space view API (``ops/views.py`` ``get_views``), two resample
helpers (``nearest_pick_indices``, ``compute_downsampling_size``) and the
DDIM scheduler's eager API (``scale_model_input``, ``step``, ``add_noise``,
``undo_step_from_coeffs``): the same inputs, made from a seed with numpy,
through both packages. Bars: equal lists and equal integers; the DDIM chain
within 1e-6 max abs over 50 fp32 steps; bf16 in, bf16 out. The port's
``core/signals.py`` ``undo_step`` is built on ``undo_step_from_coeffs`` and
must draw exactly what a loop of one ``randn`` per micro-step draws.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elasticdiffusion_tpu.ops import resample as jrs
from elasticdiffusion_tpu.ops import views as jviews
from elasticdiffusion_tpu.sched.ddim import DDIMScheduler as JDDIM
from elasticdiffusion_tpu_torch.core import signals as tsig
from elasticdiffusion_tpu_torch.ops import resample as trs
from elasticdiffusion_tpu_torch.ops import views as tviews
from elasticdiffusion_tpu_torch.sched.ddim import DDIMScheduler as TDDIM

TOL = 1e-6

# the geometries of tests/test_reference_oracle.py::test_get_views_vs_reference
GEOMETRIES = [(512, 768, 32, 32), (1024, 2048, 64, 64), (2048, 2048, 64, 64),
              (384, 512, 48, 48), (520, 776, 32, 32), (512, 2048, 64, 64),
              (2048, 512, 64, 64), (1920, 1080, 64, 64)]


@pytest.mark.parametrize("H,W,ws,stride", GEOMETRIES)
def test_get_views_matches_jax(H, W, ws, stride):
    want = jviews.get_views(H, W, h_ws=ws, w_ws=ws, stride=stride)
    got = tviews.get_views(H, W, h_ws=ws, w_ws=ws, stride=stride)
    assert got == want and len(got) > 0


@pytest.mark.parametrize("H,W", [(512, 770), (516, 512)])
def test_get_views_rejects_a_size_off_the_latent_grid(H, W):
    for get_views in (jviews.get_views, tviews.get_views):
        with pytest.raises(ValueError, match="divisible by 8"):
            get_views(H, W)


@pytest.mark.parametrize("num_blocks", [1, 42 * 64, 2688])
def test_nearest_pick_indices_matches_jax(num_blocks):
    want = np.asarray(jrs.nearest_pick_indices(num_blocks))
    got = trs.nearest_pick_indices(num_blocks, device="cpu")
    assert got.dtype == torch.int32 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("h,w,f", [(64, 96, 0.6667), (128, 256, 0.5),
                                   (135, 240, 1 / 3), (97, 61, 0.999)])
def test_compute_downsampling_size_matches_jax(h, w, f):
    assert trs.compute_downsampling_size(h, w, f) \
        == jrs.compute_downsampling_size(h, w, f)


def _chain_inputs(seed=0, steps=50, shape=(1, 4, 16, 24)):
    rng = np.random.default_rng(seed)
    x0 = rng.standard_normal(shape).astype(np.float32)
    eps = rng.standard_normal((steps + 1,) + shape).astype(np.float32)
    return x0, eps


def test_ddim_chain_matches_jax():
    """add_noise at the first timestep, then 50 eager steps with seeded
    model outputs: prev and x0 of every step within 1e-6."""
    steps = 50
    js, ts = JDDIM(), TDDIM()
    jst, tst = js.set_timesteps(steps), ts.set_timesteps(steps)
    x0, eps = _chain_inputs(steps=steps)
    t0 = int(jst.timesteps[0])
    xj = js.add_noise(jnp.asarray(x0), jnp.asarray(eps[0]), t0)
    xt = ts.add_noise(torch.from_numpy(x0), torch.from_numpy(eps[0]), t0)
    assert np.abs(np.asarray(xj) - xt.numpy()).max() <= TOL
    worst = 0.0
    for i in range(steps):
        assert ts.scale_model_input(xt, int(tst.timesteps[i])) is xt
        xj, x0j = js.step(jst, jnp.asarray(eps[i + 1]), i, xj)
        xt, x0t = ts.step(tst, torch.from_numpy(eps[i + 1]), i, xt)
        worst = max(worst, np.abs(np.asarray(xj) - xt.numpy()).max(),
                    np.abs(np.asarray(x0j) - x0t.numpy()).max())
    assert worst <= TOL, worst
    assert xt.dtype == x0t.dtype == torch.float32


def test_ddim_step_and_add_noise_keep_bf16():
    """A bf16 sample gives bf16 (prev, x0), computed in fp32: the port's
    bf16 result is the JAX package's rounded fp32 one."""
    ts, js = TDDIM(), JDDIM()
    tst, jst = ts.set_timesteps(50), js.set_timesteps(50)
    x0, eps = _chain_inputs(seed=1, steps=1)
    xb, eb = (torch.from_numpy(a).bfloat16() for a in (x0, eps[0]))
    prev, x0_hat = ts.step(tst, eb, 7, xb)
    assert prev.dtype == x0_hat.dtype == torch.bfloat16
    jprev, jx0 = js.step(jst, jnp.asarray(eb.float().numpy(), jnp.bfloat16), 7,
                         jnp.asarray(xb.float().numpy(), jnp.bfloat16))
    assert jprev.dtype == jnp.bfloat16
    np.testing.assert_array_equal(prev.float().numpy(),
                                  np.asarray(jprev, np.float32))
    np.testing.assert_array_equal(x0_hat.float().numpy(),
                                  np.asarray(jx0, np.float32))
    assert ts.add_noise(xb, eb, 981).dtype == torch.bfloat16


@pytest.mark.parametrize("steps,index", [(50, 10), (4, 0), (50, 48)])
def test_undo_step_from_coeffs_matches_jax(steps, index):
    js, ts = JDDIM(), TDDIM()
    jst = js.set_timesteps(steps)
    s1mb, sb = js.undo_step_coeffs(jst, int(jst.timesteps[index]))
    x0, _ = _chain_inputs(seed=2, steps=0)
    rng = np.random.default_rng(3)
    noises = rng.standard_normal((len(s1mb),) + x0.shape).astype(np.float32)
    want = js.undo_step_from_coeffs(jnp.asarray(x0), jnp.asarray(noises),
                                    s1mb, sb)
    got = ts.undo_step_from_coeffs(torch.from_numpy(x0),
                                   torch.from_numpy(noises), s1mb, sb)
    assert np.abs(np.asarray(want) - got.numpy()).max() <= TOL


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_undo_step_draws_one_randn_per_micro_step(dtype):
    """The port's undo_step against a loop that draws each micro-step's
    noise from the generator just before it is used: bitwise equal, and
    the generator left in the same state."""
    ts = TDDIM()
    s1mb, sb = ts.undo_step_coeffs(ts.set_timesteps(50), 401)
    x = torch.from_numpy(_chain_inputs(seed=4, steps=0)[0]).to(dtype)
    ga, gb = (torch.Generator().manual_seed(5) for _ in range(2))
    want = x
    for a, b in zip(s1mb, sb):
        noise = torch.randn(x.shape, generator=ga, dtype=dtype)
        want = float(a) * want + float(b) * noise
    got = tsig.undo_step(x, gb, s1mb, sb)
    assert got.dtype == dtype
    assert torch.equal(got, want)
    assert torch.equal(ga.get_state(), gb.get_state())
