"""The multi-GPU slice on the CPU: the port's ('data', 'views') mesh of
processes against its own one-process runs and against the JAX package's
mesh on the 8 virtual CPU devices of tests/conftest.py.

The port's ranks are processes (``tests/torch_port_mesh_worker.py``, gloo
through a ``FileStore`` under the test's temporary directory), started
twice: once at world 2 and once at world 4, each start running every case
of its world size. The JAX side and the port's one-process runs run in the
test process. Randomness is injected as ``pipeline_parity_run`` injects it
where the JAX package is compared (initial latent, picks and repaint noise
from a numpy seed, the JAX package's background tables replayed); the
port-only comparisons use the port's own seeded draws, which are the same on
every rank.

Bars: mesh against one process atol 2e-5 (the JAX package's sharding bar,
tests/test_sharding.py), per step-end latent MAE < 1e-3 against the JAX
mesh run (the pipeline bar), every rank bitwise equal to rank 0, the mesh
halo decode atol 1e-4 / rtol 1e-3 (tests/test_halo_decode.py).
"""

import copy
import dataclasses
import functools
import os

import numpy as np
import pytest
import torch
from PIL import Image

import elasticdiffusion_tpu.core.pipeline as jpipe
from elasticdiffusion_tpu.ops.resample import build_resample_plan
from elasticdiffusion_tpu.parallel import sharding as jsh
from elasticdiffusion_tpu.parallel.halo_decode import halo_decode as jhalo

import elasticdiffusion_tpu_torch.apps.cli as tcli
import elasticdiffusion_tpu_torch.core.background as tbg
from elasticdiffusion_tpu_torch.core.pipeline import ElasticDiffusion as TElastic
from elasticdiffusion_tpu_torch.models.convert import save_bundle
from elasticdiffusion_tpu_torch.models.registry import load_bundle
from elasticdiffusion_tpu_torch.parallel import halo_decode as thd
from elasticdiffusion_tpu_torch.parallel import sharding as tsh
import torch_port_mesh_worker as worker
from toy_configs import toy_bundle_config
from torch_port_common import (TORCH_TOY_RUNTIME, _jax_step_latents,
                               _scripted, port_bundle_config, t2n,
                               to_numpy_tree, toy_bundles)

STEP = dict(num_inference_steps=2, guidance_scale=7.5, resampling_steps=1,
            new_p=0.3, rrg_init_weight=1000.0, rrg_stop_t=0.0,
            repaint_sampling=True)
H, W = 32, 48      # latent 16x24: 24 views, direction batch 4, repaint 2
WORLD2 = {"1x2": ((1, 2), ("a photo of a cat",))}
WORLD4 = {"1x4": ((1, 4), ("a photo of a cat",)),
          "2x2": ((2, 2), ("a photo of a cat", "a photo of a dog"))}
HALO_LATENT = (1, 4, 32, 16)
SEED = 100


def _spec(jb):
    """The numpy weights of a JAX toy bundle, for the ranks."""
    return {"config": port_bundle_config(jb.config),
            "unet": to_numpy_tree(jb.unet_params),
            "vae": to_numpy_tree(jb.vae_params),
            "text": [to_numpy_tree(p) for p in jb.text_params]}


def _seeded(xl=False, controlnet=None):
    """A toy bundle of the port alone, from seed SEED (no JAX bundle is
    built), and its spec: rank r builds it from SEED + r, so that only
    put_replicated makes the ranks' weights rank 0's."""
    cfg = port_bundle_config(toy_bundle_config(xl=xl))
    tb = load_bundle(cfg.sd_version, TORCH_TOY_RUNTIME, bundle_config=cfg,
                     controlnet_model=controlnet, device="cpu", seed=SEED)
    return tb, {"config": cfg, "controlnet_model": controlnet, "seed": SEED}


def _injected(jb, prompts, seed=0):
    """generate_image arguments with injected randomness (numpy)."""
    vsf = jb.vae_scale_factor
    h, w = H // vsf, W // vsf
    jp = jpipe.ElasticDiffusion(bundle=jb)
    plan = build_resample_plan(h, w, *jp.get_downsample_size(H, W))
    rng = np.random.default_rng(seed)
    B = len(prompts)
    init = rng.standard_normal((B, 4, h, w)).astype(np.float32)
    return dict(height=H, width=W, latents=init, **STEP,
                scripted_noise=_scripted(rng, STEP["num_inference_steps"],
                                         STEP["resampling_steps"],
                                         plan.num_blocks, (B, 4, h, w), True))


def _jax_mesh_run(jb, shape, prompts, kw, tmp_path):
    """The JAX package's generate_image on make_mesh(shape): per-step
    latents and the background tables it drew. A shallow copy of the cached
    toy bundle takes the replicated weights, so the cache stays on one
    device."""
    jp = jpipe.ElasticDiffusion(bundle=copy.copy(jb), mesh=jsh.make_mesh(shape))
    jp.seed_everything(0)
    recorded = []
    make = jpipe.make_background_table
    jpipe.make_background_table = lambda *a, **k: (
        recorded.append(make(*a, **k)), recorded[-1])[1]
    tmp_path.mkdir()
    try:
        _, lats = _jax_step_latents(jp, tmp_path, list(prompts), **kw)
    finally:
        jpipe.make_background_table = make
    tables = [{s: np.asarray(v) for s, v in t.items()} for t in recorded]
    return lats, tables


def _port_run(tb, prompts, kw, tables=None, view_batch_size=0, seed=0):
    """The port's one-process generate_image: (image, final latent, step
    latents, UNet rows per call)."""
    tp = TElastic(bundle=tb, device="cpu", view_batch_size=view_batch_size)
    tp.seed_everything(seed)
    rows = []
    hook = tb.unet.register_forward_pre_hook(
        lambda m, args: rows.append(int(args[0].shape[0])))
    make = tbg.make_background_table
    if tables is not None:
        replay = iter(tables)
        tbg.make_background_table = lambda *a, **k: {
            s: torch.tensor(v) for s, v in next(replay).items()}
    try:
        img, info = tp.generate_image(list(prompts), return_arrays=True, **kw)
    finally:
        tbg.make_background_table = make
        hook.remove()
    return img, info["latent"], [t2n(l) for l in tp.last_step_latents], rows


def _generate_job(name, bundle, shape, prompts, kw, tables=None, **extra):
    return dict(name=name, kind="generate", bundle=bundle, mesh=shape,
                prompts=prompts, kw=kw, tables=tables, **extra)


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    """Every world-2 case: the elastic step on 1x2 (toy SD, injected), toy
    SDXL and a toy ControlNet on 1x2 (own draws, weights from a seed per
    rank), a ragged view_batch_size against the unchunked mesh run, and the
    CLI with --mesh 1x2."""
    tmp = tmp_path_factory.mktemp("world2")
    jb, tb = toy_bundles()
    tx, xl_spec = _seeded(xl=True)
    tc, cn_spec = _seeded(controlnet="canny")
    cond = np.random.default_rng(3).random((1, 3, 40, 64)).astype(np.float32)
    own = dict(height=H, width=W, **STEP)
    ragged = dict(height=40, width=40, **STEP)      # 25 views, chunks of 3
    out = {"port": {}, "jax": {}}
    jobs = []
    for key, (shape, prompts) in WORLD2.items():
        kw = _injected(jb, prompts)
        out["jax"][key], tables = _jax_mesh_run(jb, shape, prompts, kw,
                                                tmp / key)
        out["port"][key] = _port_run(tb, prompts, kw, tables)
        jobs.append(_generate_job(key, "sd", shape, prompts, kw, tables))
    out["port"]["xl"] = _port_run(tx, ["a cat"], own)
    jobs.append(_generate_job("xl", "xl", (1, 2), ["a cat"], own))
    cn_kw = dict(own, condition_image=cond, controlnet_conditioning_scale=0.7)
    out["port"]["cn"] = _port_run(tc, ["a cat"], cn_kw)
    jobs.append(_generate_job("cn", "cn", (1, 2), ["a cat"], cn_kw))
    jobs.append(_generate_job("ragged", "sd", (1, 2), ["a cat"], ragged,
                              view_batch_size=3))
    jobs.append(_generate_job("whole", "sd", (1, 2), ["a cat"], ragged))

    # the CLI from a toy checkpoint: 1x1 here, 1x2 in the ranks
    ckpt = str(tmp / "ckpt")
    save_bundle(tb, ckpt)
    argv = ["--sd_version", "toy", "--checkpoint_dir", ckpt, "--H", "32",
            "--W", "48", "--steps", "2", "--resampling_steps", "1",
            "--fp32", "true", "--seed", "3", "--prompt", "a cat"]
    make_pipe = tcli.make_pipe
    tcli.make_pipe = functools.partial(make_pipe, device="cpu",
                                       bundle_config=tb.config)
    try:
        out["cli_1x1"] = tcli.main(argv + ["--outdir", str(tmp / "out1")])
    finally:
        tcli.make_pipe = make_pipe
    jobs.append(dict(name="cli", kind="cli", config=tb.config,
                     argv=argv + ["--outdir", str(tmp / "out2"),
                                  "--mesh", "1x2"]))
    specs = {"sd": _spec(jb), "xl": xl_spec, "cn": cn_spec}
    out["ranks"] = worker.spawn(2, str(tmp), specs, jobs)
    out["cli_outdir"] = str(tmp / "out2")
    return out


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    """Every world-4 case: the elastic step on 1x4 and on 2x2 (the 2-prompt
    batch), injected; halo_decode on a 1x4 mesh, and on a latent whose rows
    4 does not divide."""
    tmp = tmp_path_factory.mktemp("world4")
    jb, tb = toy_bundles()
    out = {"port": {}, "jax": {}}
    jobs = []
    for key, (shape, prompts) in WORLD4.items():
        kw = _injected(jb, prompts)
        out["jax"][key], tables = _jax_mesh_run(jb, shape, prompts, kw,
                                                tmp / key)
        out["port"][key] = _port_run(tb, prompts, kw, tables)
        jobs.append(_generate_job(key, "sd", shape, prompts, kw, tables))
    rng = np.random.default_rng(2)
    for name, shape in (("halo", HALO_LATENT), ("halo_ragged", (1, 4, 18, 16))):
        z = rng.standard_normal(shape).astype(np.float32)
        jobs.append(dict(name=name, kind="halo", bundle="sd", mesh=(1, 4),
                         latent=z))
        out[name] = (z, t2n(thd.halo_decode(tb, torch.from_numpy(z),
                                            num_bands=1)))
    out["jax_halo"] = np.asarray(jhalo(jb, out["halo"][0],
                                       mesh=jsh.make_mesh((1, 4))))
    out["ranks"] = worker.spawn(4, str(tmp), {"sd": _spec(jb)}, jobs)
    return out


def _world(request, key):
    return request.getfixturevalue("world4" if key in WORLD4 else "world2")


# ---------------------------------------------------------------------------
# helpers, no processes
# ---------------------------------------------------------------------------

class _Mesh:
    """What the port's helpers read of a DeviceMesh: its dim names and
    sizes."""

    def __init__(self, views):
        self.mesh_dim_names = ("data", "views")
        self._sizes = (1, views)

    def size(self, dim):
        return self._sizes[dim]


@pytest.mark.parametrize("width", [1, 2, 4])
@pytest.mark.parametrize("n", range(1, 10))
def test_pad_helpers_match_jax(n, width):
    """view_pad_rows and pad_rows_to_mesh against the JAX package's, for
    a leading axis of n rows on a views axis `width` wide. Where more rows
    are missing than there are (n=1 on 4), the JAX package's x[:pad] falls
    short of the width; the port repeats the rows in turn."""
    jmesh = jsh.make_mesh((1, width))
    tmesh = None if width == 1 else _Mesh(width)
    x = np.arange(n * 3, dtype=np.float32).reshape(n, 3)
    pad = tsh.view_pad_rows(n, tmesh)
    assert pad == jsh.view_pad_rows(n, jmesh) == (-n) % width
    got = t2n(tsh.pad_rows_to_mesh(torch.from_numpy(x), tmesh))
    want = np.asarray(jsh.pad_rows_to_mesh(x, jmesh))
    assert got.shape[0] % width == 0
    if pad <= n:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_array_equal(got, x[np.arange(n + pad) % n])
    assert tsh.auto_mesh_shape(width) == jsh.auto_mesh_shape(width)


def test_one_rank_is_no_mesh():
    assert tsh.make_mesh((1, 1)) is None is jsh.make_mesh((1, 1))
    assert tsh.views_size(None) == 1 and tsh.views_rank(None) == 0
    assert tsh.is_first_rank()
    calls = []
    x = torch.ones(3, 2)
    assert tsh.sharded_call(lambda a, b: calls.append(b) or a, None, x,
                            None) is x
    assert calls == [None]


@pytest.mark.parametrize("shape", [(1, 2), (2, 2), (1, 8)])
def test_a_world_size_mismatch_raises_naming_both(shape):
    n = shape[0] * shape[1]
    with pytest.raises(ValueError, match=f"needs {n} processes, the world "
                                         f"has 1"):
        tsh.make_mesh(shape, device_type="cpu")
    with pytest.raises(ValueError, match=f"needs {n} processes"):
        TElastic(bundle=toy_bundles()[1], device="cpu",
                 runtime=dataclasses.replace(TORCH_TOY_RUNTIME,
                                             mesh_shape=shape))


# ---------------------------------------------------------------------------
# the elastic step on a mesh
# ---------------------------------------------------------------------------

MESHES = list(WORLD2) + list(WORLD4)


@pytest.mark.parametrize("key", MESHES)
def test_mesh_run_equals_one_process(key, request):
    out = _world(request, key)
    img, lat, lats, _ = out["port"][key]
    got = out["ranks"][0][key]
    assert len(got["step_latents"]) == len(lats) == 2
    for a, b in zip(got["step_latents"], lats):
        np.testing.assert_allclose(a, b, atol=2e-5, rtol=1e-5)
    np.testing.assert_allclose(got["latent"], lat, atol=2e-5, rtol=1e-5)
    np.testing.assert_allclose(got["image"], img, atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("key", MESHES)
def test_mesh_run_matches_jax_mesh(key, request):
    out = _world(request, key)
    got = out["ranks"][0][key]["step_latents"]
    want = out["jax"][key]
    assert len(got) == len(want) == 2
    for i, (a, b) in enumerate(zip(got, want)):
        d = np.abs(a - b)
        assert d.mean() < 1e-3 and d.max() < 1e-2, (i, d.mean(), d.max())


@pytest.mark.parametrize("key", MESHES + ["xl", "cn", "ragged"])
def test_every_rank_ends_bitwise_equal(key, request):
    ranks = _world(request, key)["ranks"]
    for field in ("latent", "image", "step_latents"):
        assert worker.same_everywhere(ranks, key, field), field


@pytest.mark.parametrize("key", MESHES + ["cn"])
def test_each_rank_runs_its_share_of_every_unet_batch(key, request):
    """Per call, each rank's UNet rows are the padded total / views width:
    the direction batch 2(rs+1)B, the repaint direction 2B and the view
    batch VB of the one-process run, padded to the width."""
    out = _world(request, key)
    one = out["port"][key][3]
    width = out["ranks"][0][key]["views_width"]
    padded = [r + (-r) % width for r in one]
    for rank in out["ranks"]:
        assert rank[key]["rows"] == [p // width for p in padded]
        assert all(r < o for r, o in zip(rank[key]["rows"], one))
    views = len(out["ranks"]) // width  # ranks that share one 'views' index
    assert [sum(r[key]["rows"][i] for r in out["ranks"]) // views
            for i in range(len(one))] == padded
    inv = out["ranks"][0][key]["collectives"]
    assert inv["all_gather"]["count"] == len(one)
    assert set(inv["all_gather"]["routes"]) == {"gloo:cpu"}


def test_sdxl_and_controlnet_on_1x2_equal_one_process(world2):
    """Toy SDXL (its text_time conditioning split with the batch) and a toy
    ControlNet (its residual inputs split) on 1x2, against one process on
    rank 0's weights: rank 1 built other weights and ran half of every
    batch with what put_replicated gave it."""
    for key in ("xl", "cn"):
        img, lat, _, _ = world2["port"][key]
        got = world2["ranks"][0][key]
        np.testing.assert_allclose(got["latent"], lat, atol=2e-5, rtol=1e-5)
        np.testing.assert_allclose(got["image"], img, atol=2e-5, rtol=1e-5)


def test_ragged_view_chunks_on_1x2_equal_the_whole_view_batch(world2):
    """25 views in chunks of 3 (eight of 3 rows padded to 4, the last of 1
    padded to 2) against the same request in one view batch of 25 rows."""
    a, b = world2["ranks"][0]["ragged"], world2["ranks"][0]["whole"]
    np.testing.assert_allclose(a["latent"], b["latent"], atol=2e-5, rtol=1e-5)
    # direction 4, views 8 x 2 + 1, repaint 1 + views 8 x 2 + 1 (per step)
    assert a["rows"][:10] == [2] + [2] * 8 + [1]
    assert b["rows"][:2] == [2, 13]


# ---------------------------------------------------------------------------
# the halo decode on a mesh
# ---------------------------------------------------------------------------

def test_halo_decode_on_1x4_equals_monolithic_and_jax(world4):
    z, mono = world4["halo"]
    for rank in world4["ranks"]:
        got = rank["halo"]["image"]
        assert got.shape == mono.shape == (1, 3, 64, 32)
        np.testing.assert_allclose(got, mono, atol=1e-4, rtol=1e-3)
        np.testing.assert_array_equal(got, world4["ranks"][0]["halo"]["image"])
    np.testing.assert_allclose(world4["ranks"][0]["halo"]["image"],
                               world4["jax_halo"], atol=1e-4, rtol=1e-3)


def test_halo_decode_norms_go_through_the_halves(world4):
    """Every GroupNorm of the mesh stage b: one moment_sums, one
    all_reduce of its sums and one scale_shift, in the order and at the
    shapes mesh_norm_shapes lists (chip_smoke.py builds the halves' kernel
    cases from it); one all_gather of halo rows before every 3x3 conv and
    one of the bands."""
    cfg = toy_bundles()[1].config.vae
    shapes = thd.mesh_norm_shapes(cfg, 1, 32, 16, 4)
    norms = len(shapes) // 2
    blocks = len(cfg.block_out_channels)
    convs = 2 * blocks * (cfg.layers_per_block + 1) + (blocks - 1) + 1
    for rank in world4["ranks"]:
        r = rank["halo"]
        assert r["calls"] == shapes
        assert r["collectives"]["all_reduce"]["count"] == norms
        assert r["collectives"]["all_gather"]["count"] == convs + 1
    assert norms == 2 * blocks * (cfg.layers_per_block + 1) + 1


def test_halo_decode_rows_that_4_does_not_divide_take_one_gpu_route(world4):
    z, mono = world4["halo_ragged"]
    for rank in world4["ranks"]:
        r = rank["halo_ragged"]
        np.testing.assert_array_equal(r["image"], mono)
        assert r["collectives"] == {} and r["calls"] == []


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def test_cli_mesh_1x2_writes_the_1x1_image_once(world2):
    assert world2["ranks"][1]["cli"]["save_dir"] is None
    save_dir = world2["ranks"][0]["cli"]["save_dir"]
    runs = os.listdir(os.path.join(world2["cli_outdir"], "ElasticDiffusion"))
    assert [os.path.join(world2["cli_outdir"], "ElasticDiffusion", runs[0])] \
        == [save_dir]
    got = np.asarray(Image.open(os.path.join(save_dir, "0.png")))
    want = np.asarray(Image.open(os.path.join(world2["cli_1x1"], "0.png")))
    np.testing.assert_array_equal(got, want)
    assert "mesh: 1x2" in open(os.path.join(save_dir, "args.txt")).read()


def test_cli_mesh_in_a_world_of_one_raises():
    argv = ["--sd_version", "toy", "--mesh", "1x2"]
    opt = tcli.build_parser().parse_args(argv)
    assert tcli.runtime_config(opt).mesh_shape == (1, 2)
    with pytest.raises(ValueError, match="needs 2 processes, the world has 1"):
        tcli.make_pipe(opt, device="cpu",
                       bundle_config=toy_bundles()[1].config)
