"""The slice as a whole: the port's generate_image against the JAX pipeline
on the toy SD bundle, and the rules of the port's entry points.

Both pipelines get the same injected initial latent, picks and repaint noise
(numpy, from a seed) and the same background tables: the JAX package draws
them with jax.random inside make_background_table, so the test records the
JAX tables and hands them to the port in the place of its own. The toy
geometry (32x48 px) pads the downsampled latent, so the tables are in use.
Bars: per step-end latent MAE < 1e-3 and max < 1e-2, those of
tests/test_parity.py.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from elasticdiffusion_tpu.core.pipeline import ElasticDiffusion as JElastic

from elasticdiffusion_tpu_torch.core.pipeline import ElasticDiffusion as TElastic
from torch_port_common import pipeline_parity_run, t2n, toy_bundles

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("repaint,rrg,rs", [
    (False, False, 2),   # resampling only
    (False, True, 1),    # + RRG
    (True, False, 1),    # + repaint (the last step never repaints)
    (True, True, 2),     # everything
])
def test_generate_image_matches_jax_pipeline(repaint, rrg, rs, monkeypatch, tmp_path):
    jb, tb = toy_bundles()
    steps, height, width = 2, 32, 48
    jp, tp, jimg, jlats, timg, tinfo, tlats = pipeline_parity_run(
        jb, tb, monkeypatch, tmp_path, repaint=repaint, rrg=rrg, rs=rs,
        steps=steps, height=height, width=width)

    assert len(jlats) == len(tlats) == steps
    np.testing.assert_array_equal(tlats[-1], tinfo["latent"])
    for i, (a, b) in enumerate(zip(tlats, jlats)):
        d = np.abs(a - b)
        assert d.mean() < 1e-3 and d.max() < 1e-2, (i, d.mean(), d.max())
    assert timg.shape == jimg.shape == (1, 3, height, width)
    assert np.abs(timg - jimg).max() < 1e-2
    m = tp.last_metrics
    V = m["views"]
    assert m["steps"] == steps and V == jp.last_metrics["views"]
    assert m["unet_view_forwards"] == jp.last_metrics["unet_view_forwards"] \
        == steps * (2 * (rs + 1) + V) + (steps - 1) * (2 + V) * int(repaint)
    assert m["denoise_seconds"] > 0 and m["decode_seconds"] > 0


def test_generate_image_own_randomness_and_return_forms():
    """Without injected randomness: seeded, repeatable, finite, in [0, 1];
    PIL and grid returns; view_batch_size chunks give the same latent."""
    _, tb = toy_bundles()
    tp = TElastic(bundle=tb, device="cpu")
    kw = dict(height=32, width=48, num_inference_steps=2, resampling_steps=1)
    tp.seed_everything(5)
    a, ia = tp.generate_image("a cat", return_arrays=True, **kw)
    tp.seed_everything(5)
    tp.view_batch_size = 5   # 24 views: a ragged last chunk of 4
    b, ib = tp.generate_image("a cat", return_arrays=True, **kw)
    tp.view_batch_size = 0
    tp.seed_everything(6)
    c, _ = tp.generate_image("a cat", return_arrays=True, **kw)
    assert np.isfinite(a).all() and a.min() >= 0 and a.max() <= 1 and a.std() > 0
    np.testing.assert_allclose(ia["latent"], ib["latent"], atol=1e-5)
    assert not np.array_equal(a, c)
    pil, log = tp.generate_image(["a cat", "a dog"], **kw)
    assert len(pil) == 2 and pil[0].size == (48, 32) and log == {}
    grid, _ = tp.generate_image(["a cat", "a dog"], grid=True, **kw)
    assert len(grid) == 1 and grid[0].size[0] > 2 * 48
    calls = []
    tp.generate_image("a cat", progress=lambda it: calls.append(1) or it, **kw)
    assert calls == [1]


def test_verbose_image_log():
    _, tb = toy_bundles()
    tp = TElastic(bundle=tb, device="cpu", verbose=True, log_freq=1)
    _, log = tp.generate_image("a cat", height=32, width=48,
                               num_inference_steps=2, resampling_steps=1)
    assert {"global_img", "intermediate_x0_imgs",
            "intermediate_cascade_x0_imgs"} <= set(log)
    assert log["global_img"].size == (2 * 8, 2 * 5)  # the 5x8 low-res latent


def test_vanilla_generate_matches_jax():
    import jax.numpy as jnp
    jb, tb = toy_bundles()
    jp, tp = JElastic(bundle=jb), TElastic(bundle=tb, device="cpu")
    rng = np.random.default_rng(1)
    lat = rng.standard_normal((1, 4, 8, 8)).astype(np.float32)
    u, _ = jp.get_text_embeds([""])
    c, _ = jp.get_text_embeds(["a photo of a cat"])
    text = np.concatenate([np.asarray(u), np.asarray(c)])
    tu, _ = tp.get_text_embeds([""])
    assert np.abs(t2n(tu) - np.asarray(u)).max() < 5e-5
    jimg, _ = jp.generate(jnp.asarray(lat), jnp.asarray(text), num_inference_steps=3)
    timg, info = tp.generate(lat, torch.from_numpy(text), num_inference_steps=3)
    assert np.abs(t2n(timg) - np.asarray(jimg)).max() < 1e-3
    assert len(info["inter_x0"]) == 1


def test_entry_points_default_to_cuda_and_raise_without_it():
    _, tb = toy_bundles()
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device: the default device exists")
    with pytest.raises(RuntimeError, match="CUDA"):
        TElastic(bundle=tb)            # default device="cuda"
    with pytest.raises(RuntimeError, match="CUDA"):
        TElastic(sd_version="2.1")     # would build the full model on the GPU


@pytest.mark.parametrize("kwargs", [
    dict(tiled_decoder=True),
    dict(checkpoint_path="latent.npz", checkpoint_every=1),
    dict(resume_from="latent.npz"),
], ids=["tiled_decoder", "checkpoint_path", "resume_from"])
def test_later_slices_raise_not_implemented(kwargs, tmp_path):
    """These arguments belonged to later slices and run now (the decode at
    large sizes and latent checkpoint/resume are ported): a one-step run
    with each gives the plain run's image (the halo decode equals the
    monolithic one within the streamed decode's bar, atol 1e-4 on values in
    [0, 1]; a checkpoint and a resume from it change nothing); what of them
    is still to come, a device mesh for the halo decode, raises."""
    _, tb = toy_bundles()
    tp = TElastic(bundle=tb, device="cpu")
    kw = dict(height=32, width=48, num_inference_steps=1, resampling_steps=0,
              return_arrays=True)
    plain, _ = tp.generate_image("a cat", **kw)
    kwargs = {k: str(tmp_path / v) if k != "tiled_decoder" and
              isinstance(v, str) else v for k, v in kwargs.items()}
    if "resume_from" in kwargs:  # a checkpoint of the run's only step
        tp.generate_image("a cat", checkpoint_path=kwargs["resume_from"],
                          checkpoint_every=1, **kw)
        # resuming after the last step leaves the latent as saved
        img, info = tp.generate_image("a cat", **kwargs, **kw)
        assert tp.last_step_latents == []
    else:
        img, info = tp.generate_image("a cat", **kwargs, **kw)
    np.testing.assert_allclose(img, plain, atol=1e-4)
    if "checkpoint_path" in kwargs:
        assert set(np.load(kwargs["checkpoint_path"]).files) == {
            "latent", "step", "generator"}
    from elasticdiffusion_tpu_torch.parallel.halo_decode import halo_decode
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        halo_decode(tb, torch.zeros(1, 4, 4, 4), mesh=object())


@pytest.mark.parametrize("kwargs", [dict(mesh=object()),
                                    dict(low_vram=True),
                                    dict(bundle=None, sd_version="toy",
                                         checkpoint_dir="toy checkpoint")],
                         ids=["mesh", "low_vram", "checkpoint_dir"])
def test_later_slices_raise_in_constructor(kwargs, monkeypatch, tmp_path):
    """A mesh still raises; low_vram (which shapes the tiled decode) is
    accepted since the decode at large sizes is ported, and checkpoint_dir
    since loading checkpoints is: the constructor loads a toy checkpoint
    directory (its bundle config handed to load_bundle here)."""
    import elasticdiffusion_tpu_torch.core.pipeline as tpipe
    from elasticdiffusion_tpu_torch.models.convert import save_bundle
    from torch_port_common import TORCH_TOY_RUNTIME
    _, tb = toy_bundles()
    if "low_vram" in kwargs:
        assert TElastic(bundle=tb, device="cpu", **kwargs).low_vram
    elif "checkpoint_dir" in kwargs:
        save_bundle(tb, str(tmp_path))
        kwargs = dict(kwargs, checkpoint_dir=str(tmp_path))
        load = tpipe.load_bundle
        monkeypatch.setattr(tpipe, "load_bundle", lambda *a, **k: load(
            *a, bundle_config=tb.config, seed=1, **k))
        pipe = TElastic(device="cpu", runtime=TORCH_TOY_RUNTIME, **kwargs)
        for a, b in zip(pipe.bundle.unet.parameters(), tb.unet.parameters()):
            assert torch.equal(a, b)
    else:
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            TElastic(**{"bundle": tb, "device": "cpu", **kwargs})
    with pytest.raises(ValueError, match="divisible"):
        TElastic(bundle=tb, device="cpu").generate_image("x", height=33, width=48)


@pytest.mark.parametrize("code", [
    "import elasticdiffusion_tpu_torch\n"
    "import elasticdiffusion_tpu_torch.core.pipeline\n"
    "import elasticdiffusion_tpu_torch.models.convert\n"
    "import elasticdiffusion_tpu_torch.kernels.build\n",
    "import chip_smoke\n",
], ids=["package", "chip_smoke"])
def test_port_imports_neither_jax_nor_the_jax_package(code):
    """In a fresh interpreter: importing every module of the port, or
    chip_smoke.py, pulls in neither jax, flax nor elasticdiffusion_tpu."""
    probe = (code + "import sys\n"
             "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
             "('jax', 'jaxlib', 'flax', 'elasticdiffusion_tpu'))\n"
             "assert not bad, bad\n"
             "import pkgutil, importlib, elasticdiffusion_tpu_torch as p\n"
             "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
             "    importlib.import_module(m.name)\n"
             "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
             "('jax', 'jaxlib', 'flax', 'elasticdiffusion_tpu'))\n"
             "assert not bad, bad\nprint('clean')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().endswith("clean")


def test_chip_smoke_fails_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
