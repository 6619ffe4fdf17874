"""The port's large-size decode against the JAX package's, on the CPU.

The decoder's stage split (``AutoencoderKL.decode_stage_a`` /
``decode_stage_b``), ``parallel/halo_decode.py``'s three branches (monolithic,
streamed, sequential bands), the plain versions of the GroupNorm kernel's
two halves, ``tiled_decode`` and ``generate_image(tiled_decoder=True)``.
Weights: the cached toy bundles with every leaf perturbed
(``tests/test_torch_port_perturbed.py``), so no bias or norm weight is at
its init. Inputs from numpy seeds; fp32.

Bars, each stated at its test: 3e-5 between the two packages' modules (the
bar of tests/test_torch_port_perturbed.py); atol 1e-4, rtol 1e-3 between
the streamed and the monolithic stage b, the JAX package's own bar for that
comparison (tests/test_halo_decode.py); per-step latent MAE < 1e-3 and
images within 1e-2 for generate_image (tests/test_parity.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_perturbed import perturbed_bundles
from torch_port_common import (max_abs, pipeline_parity_run, t2n,
                               toy_bundles)

from elasticdiffusion_tpu.kernels.groupnorm import (
    fused_group_norm as jax_fused_group_norm)
from elasticdiffusion_tpu.parallel import halo_decode as jhd
from elasticdiffusion_tpu_torch.kernels.groupnorm import (
    group_scale_shift, reference_group_norm_apply, reference_group_norm_sums)
from elasticdiffusion_tpu_torch.parallel import halo_decode as thd

TOL = 3e-5


def _latent(seed, h, w, scale=0.5):
    rng = np.random.default_rng(seed)
    return (scale * rng.standard_normal((1, 4, h, w))).astype(np.float32)


def test_stage_split_equals_decode_and_the_jax_stages():
    """decode is stage a then stage b (bitwise); each stage within 3e-5 of
    the JAX package's."""
    with perturbed_bundles() as (jb, tb):
        z = _latent(0, 16, 16)
        vae, jvae = tb.vae_fp32, type(jb.vae)
        a = vae.decode_stage_a(torch.from_numpy(z))
        b = vae.decode_stage_b(a)
        assert torch.equal(b, vae.decode(torch.from_numpy(z)))
        ja = jb.vae.apply({"params": jb.vae_params}, jnp.asarray(z),
                          method=jvae.decode_stage_a)
        jbb = jb.vae.apply({"params": jb.vae_params}, ja,
                           method=jvae.decode_stage_b)
        assert max_abs(t2n(a), np.asarray(ja)) < TOL
        assert max_abs(t2n(b), np.asarray(jbb)) < TOL


# (branch kwargs, latent): the shapes of tests/test_halo_decode.py, whose
# compiled JAX programs a process may already hold
BRANCHES = [(dict(num_bands=1), (16, 16)), (dict(streamed=True), (32, 16)),
            (dict(num_bands=4, halo=12), (32, 16))]


@pytest.mark.parametrize("kw,hw", BRANCHES, ids=["monolithic", "streamed",
                                                 "bands"])
def test_halo_decode_matches_jax_on_each_branch(kw, hw):
    """The same branch in both packages: within 3e-5 (the JAX branches run
    its functional stage b, the port the modules or F.conv2d with the
    modules' weights: the same math in another order of sums)."""
    with perturbed_bundles() as (jb, tb):
        z = _latent(1, *hw)
        want = np.asarray(jhd.halo_decode(jb, jnp.asarray(z), mesh=None, **kw))
        got = t2n(thd.halo_decode(tb, torch.from_numpy(z), **kw))
        assert got.shape == want.shape == (1, 3, 2 * hw[0], 2 * hw[1])
        assert max_abs(got, want) < TOL, max_abs(got, want)


# slab budgets: one row a window; every row in one window; and 3840 bytes,
# which cuts the toy's two levels (15 and 30 rows of 24 and 48 columns of
# 8 channels) unevenly: 5-row windows at the first, 2-row at the second
CHUNKS = [1, 1 << 40, 3840]


@pytest.mark.parametrize("chunk_bytes", CHUNKS, ids=["one_row", "all_rows",
                                                     "uneven"])
def test_streamed_equals_monolithic(chunk_bytes, monkeypatch):
    """The exact streamed stage b against the monolithic one, within the
    JAX package's bar for the same comparison (atol 1e-4, rtol 1e-3)."""
    monkeypatch.setattr(thd, "CHUNK_BYTES", chunk_bytes)
    with perturbed_bundles() as (_, tb):
        z = torch.from_numpy(_latent(2, 15, 24))
        want = t2n(thd.halo_decode(tb, z, num_bands=1))
        got = t2n(thd.halo_decode(tb, z, streamed=True))
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-3)


def test_uneven_chunks_are_uneven(monkeypatch):
    """The 'uneven' budget above does cut the levels unevenly."""
    cfg = toy_bundles()[1].config.vae
    assert cfg.block_out_channels == (4, 8)
    monkeypatch.setattr(thd, "CHUNK_BYTES", 3840)
    assert [thd._row_chunk(15, 24, 8), thd._row_chunk(30, 48, 8)] == [5, 2]


@pytest.mark.parametrize("chunk_bytes", CHUNKS, ids=["one_row", "all_rows",
                                                     "uneven"])
def test_streamed_norm_shapes_are_the_launches(chunk_bytes, monkeypatch):
    """streamed_norm_shapes (from which chip_smoke.py builds the halves'
    kernel cases) lists the halves' calls of a streamed decode, in order."""
    _, tb = toy_bundles()
    monkeypatch.setattr(thd, "CHUNK_BYTES", chunk_bytes)
    seen = []
    sums, apply = thd.moment_sums, thd.scale_shift
    monkeypatch.setattr(thd, "moment_sums", lambda x, mode: (
        seen.append(("sums", tuple(x.shape), False)), sums(x, mode))[1])
    monkeypatch.setattr(thd, "scale_shift", lambda x, a, b, silu, mode: (
        seen.append(("apply", tuple(x.shape), silu)),
        apply(x, a, b, silu, mode))[1])
    thd.halo_decode(tb, torch.from_numpy(_latent(3, 15, 24)), streamed=True)
    assert seen == thd.streamed_norm_shapes(tb.config.vae, 1, 15, 24)


def test_the_default_choice_streams_above_max_px(monkeypatch):
    _, tb = toy_bundles()
    z = torch.from_numpy(_latent(4, 8, 8))
    assert thd.choose_branch(torch.float32, 1, 8, 8, 2) == "monolithic"
    calls = []
    sums = thd.moment_sums
    monkeypatch.setattr(thd, "moment_sums",
                        lambda x, mode: (calls.append(1), sums(x, mode))[1])
    mono = thd.halo_decode(tb, z)
    assert not calls
    monkeypatch.setitem(thd.MAX_PX, torch.float32, 16 * 16 - 1)
    assert thd.choose_branch(torch.float32, 1, 8, 8, 2) == "streamed"
    streamed = thd.halo_decode(tb, z)
    assert calls
    np.testing.assert_allclose(t2n(streamed), t2n(mono), atol=1e-4, rtol=1e-3)


def test_a_mesh_raises_naming_multi_gpu():
    """The mesh branch is ported (tests/test_torch_port_mesh.py runs it on
    4 processes); a multi-GPU mesh in a job of one process raises, naming
    both counts, and mesh_norm_shapes lists its halves' launches per rank:
    a sums and an apply at the band's rows for each GroupNorm."""
    from elasticdiffusion_tpu_torch.parallel.sharding import make_mesh
    _, tb = toy_bundles()
    with pytest.raises(ValueError, match="needs 2 processes, the world has 1"):
        thd.halo_decode(tb, torch.zeros(1, 4, 8, 8),
                        mesh=make_mesh((1, 2), device_type="cpu"))
    cfg = tb.config.vae
    shapes = thd.mesh_norm_shapes(cfg, 1, 8, 6, 2)
    assert shapes[:2] == [("sums", (1, 4, 6, 8), False),
                          ("apply", (1, 4, 6, 8), True)]
    assert shapes[-1] == ("apply", (1, 8, 12, 4), True)
    assert len(shapes) == 2 * (2 * 2 * (cfg.layers_per_block + 1) + 1)


@pytest.mark.parametrize("B,H,W,C,silu", [(2, 6, 10, 128, True),
                                          (1, 9, 7, 256, False)])
def test_plain_halves_match_the_jax_kernel(B, H, W, C, silu):
    """reference_group_norm_sums, the torch step between the halves and
    reference_group_norm_apply, composed, against the JAX fused_group_norm
    in interpret mode (its two Pallas kernels); the sums against the JAX
    streamed decode's _gn_moments (32 groups: C >= 128). fp32 sums of up to
    504 terms in another order: 2e-5 on normalised values, 1e-5 relative on
    the moments."""
    rng = np.random.default_rng(5)
    x = (1.5 * rng.standard_normal((B, H, W, C)) + 0.3).astype(np.float32)
    w = (1 + 0.1 * rng.standard_normal(C)).astype(np.float32)
    b = (0.1 * rng.standard_normal(C)).astype(np.float32)
    eps = 1e-6
    tx = torch.from_numpy(x)
    sums = reference_group_norm_sums(tx)
    scale, shift = group_scale_shift(sums, H * W, torch.from_numpy(w),
                                     torch.from_numpy(b), 32, eps)
    got = t2n(reference_group_norm_apply(tx, scale, shift, silu))
    want = np.asarray(jax_fused_group_norm(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), groups=32, eps=eps,
        silu=silu, interpret=True))
    assert max_abs(got, want) < 2e-5, max_abs(got, want)

    jmean, jinv = jhd._gn_moments(jnp.asarray(x), eps)
    g = t2n(sums).reshape(B, 2, 32, C // 32).sum(-1)
    cnt = H * W * (C // 32)
    mean = g[:, 0] / cnt
    inv = 1 / np.sqrt(g[:, 1] / cnt - mean * mean + eps)
    np.testing.assert_allclose(mean, np.asarray(jmean), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(inv, np.asarray(jinv), rtol=1e-5)


@pytest.mark.parametrize("low_vram", [False, True], ids=["tiles", "low_vram"])
def test_tiled_decode_matches_jax(low_vram):
    """The reference's overlap-averaged tiles (low_vram: overlapping by
    half, with less context): within 3e-5 of the JAX package's."""
    import elasticdiffusion_tpu.core.pipeline as jpipe
    from elasticdiffusion_tpu_torch.core.pipeline import ElasticDiffusion
    with perturbed_bundles() as (jb, tb):
        lat = _latent(6, 16, 24, scale=1.0)
        jp = jpipe.ElasticDiffusion(bundle=jb, low_vram=low_vram)
        tp = ElasticDiffusion(bundle=tb, device="cpu", low_vram=low_vram)
        want = np.asarray(jp.tiled_decode(jnp.asarray(lat)))
        got = t2n(tp.tiled_decode(torch.from_numpy(lat)))
        assert got.shape == want.shape == (1, 3, 32, 48)
        assert max_abs(got, want) < TOL, max_abs(got, want)


@pytest.mark.parametrize("halo", [True, False], ids=["halo", "tiled"])
def test_generate_image_with_tiled_decoder_matches_jax(halo, monkeypatch,
                                                       tmp_path):
    """generate_image(tiled_decoder=True) in both packages, through the halo
    decode or (use_halo_decode False) the overlap-averaged tiles: per-step
    latent MAE < 1e-3 (max < 1e-2), images within 1e-2."""
    import elasticdiffusion_tpu.core.pipeline as jpipe
    from elasticdiffusion_tpu_torch.core.pipeline import ElasticDiffusion
    monkeypatch.setattr(jpipe.ElasticDiffusion, "use_halo_decode", halo,
                        raising=False)
    monkeypatch.setattr(ElasticDiffusion, "use_halo_decode", halo)
    with perturbed_bundles() as (jb, tb):
        _, tp, jimg, jlats, timg, _, tlats = pipeline_parity_run(
            jb, tb, monkeypatch, tmp_path, repaint=True, rrg=False, rs=1,
            tiled_decoder=True)
    assert tp.use_halo_decode is halo
    for i, (a, b) in enumerate(zip(tlats, jlats)):
        d = np.abs(a - b)
        assert d.mean() < 1e-3 and d.max() < 1e-2, (i, d.mean(), d.max())
    assert timg.shape == jimg.shape == (1, 3, 32, 48)
    assert np.abs(timg - jimg).max() < 1e-2
