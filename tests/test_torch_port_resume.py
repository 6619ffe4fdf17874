"""Latent checkpoint/resume and the one-step entry of the port, on the CPU.

A run resumed from a checkpoint ends with the uninterrupted run's latent,
exactly: the same code on the same inputs, and the step generator's state
restored. The checkpoints hold the JAX package's ``latent`` key, and each
holds what the JAX package's holds at the same step (per-step latent MAE
< 1e-3, max < 1e-2: the bar of tests/test_parity.py), on the cached toy
bundles with every leaf perturbed (tests/test_torch_port_perturbed.py).
``core.entry.make_denoise_step``'s step, run once, is ``generate_image``'s
first step, exactly.
"""

import itertools

import numpy as np
import pytest
import torch

from test_torch_port_perturbed import perturbed_bundles
from torch_port_common import pipeline_parity_run, toy_bundles

from elasticdiffusion_tpu_torch.core.entry import make_denoise_step
from elasticdiffusion_tpu_torch.core.pipeline import ElasticDiffusion
from elasticdiffusion_tpu_torch.utils.timeit import timelog

KW = dict(height=32, width=48, num_inference_steps=4, resampling_steps=1,
          return_arrays=True)


@pytest.mark.parametrize("every,cut", [(1, 1), (2, 2), (2, 3)],
                         ids=["every1_cut1", "every2_cut2", "every2_cut3"])
def test_resumed_run_equals_the_uninterrupted_one(every, cut, tmp_path):
    """A run cut after `cut` steps (a progress wrapper ends its loop, as an
    interrupted run would) with a checkpoint every `every` steps, then
    resumed from the file: the final latent and image equal the
    uninterrupted run's, bitwise."""
    _, tb = toy_bundles()
    tp = ElasticDiffusion(bundle=tb, device="cpu")
    tp.seed_everything(3)
    img, info = tp.generate_image("a cat", **KW)
    path = str(tmp_path / "latent.npz")
    tp.generate_image("a cat", checkpoint_path=path, checkpoint_every=every,
                      progress=lambda it: itertools.islice(it, cut), **KW)
    ck = np.load(path)
    saved = cut - cut % every - 1
    assert set(ck.files) == {"latent", "step", "generator"}
    assert int(ck["step"]) == saved
    img2, info2 = tp.generate_image("a cat", resume_from=path, **KW)
    assert len(tp.last_step_latents) == KW["num_inference_steps"] - saved - 1
    assert np.array_equal(info2["latent"], info["latent"])
    assert np.array_equal(img2, img)


def test_resume_checks_the_latent_shape(tmp_path):
    _, tb = toy_bundles()
    tp = ElasticDiffusion(bundle=tb, device="cpu")
    path = str(tmp_path / "latent.npz")
    tp.generate_image("a cat", checkpoint_path=path, checkpoint_every=1,
                      progress=lambda it: itertools.islice(it, 1), **KW)
    with pytest.raises(ValueError, match="checkpoint latent"):
        tp.generate_image("a cat", resume_from=path,
                          **{**KW, "height": 48})


def test_checkpointed_latents_match_jax(monkeypatch, tmp_path):
    """The port's checkpoint after every step, read back as the JAX
    package's are (``latent``), against the JAX package's at the same
    step, with the same injected randomness (the run of
    tests/test_torch_port_perturbed.py, whose compiled JAX step a process
    may already hold)."""
    seen = []
    original = ElasticDiffusion.generate_image

    def with_checkpoints(self, *a, **k):
        path = str(tmp_path / "port.npz")

        def progress(steps):
            for i in steps:
                if i > 0:
                    seen.append(np.load(path)["latent"])
                yield i

        out = original(self, *a, checkpoint_path=path, checkpoint_every=1,
                       progress=progress, **k)
        seen.append(np.load(path)["latent"])
        return out

    monkeypatch.setattr(ElasticDiffusion, "generate_image", with_checkpoints)
    with perturbed_bundles() as (jb, tb):
        _, _, _, jlats, _, _, tlats = pipeline_parity_run(
            jb, tb, monkeypatch, tmp_path, repaint=True, rrg=False, rs=1,
            steps=2)
    assert len(seen) == len(jlats) == len(tlats) == 2
    for i, (a, b, c) in enumerate(zip(seen, jlats, tlats)):
        assert np.array_equal(a, c)
        d = np.abs(a - b)
        assert d.mean() < 1e-3 and d.max() < 1e-2, (i, d.mean(), d.max())


@pytest.mark.parametrize("repaint", [True, False])
def test_denoise_step_is_generate_images_first_step(repaint):
    """make_denoise_step's step on its latent, generator and inputs equals
    the first step of generate_image at the same seed, bitwise; and
    generate_image is timed by timelog."""
    _, tb = toy_bundles()
    tp = ElasticDiffusion(bundle=tb, device="cpu")
    tp.seed_everything(5)
    step_fn, (lat, gen, inp), view_plan = make_denoise_step(
        tp, 32, 48, num_inference_steps=3, resampling_steps=1, repaint=repaint)
    nxt, aux = step_fn(lat, gen, inp)
    assert nxt.shape == lat.shape == (1, 4, 16, 24)
    assert view_plan.num_views >= 1
    calls = timelog.counts.get("FUNCTION_generate_image", 0)
    tp.generate_image("a photo", negative_prompts="", height=32, width=48,
                      num_inference_steps=3, resampling_steps=1,
                      repaint_sampling=repaint, return_arrays=True)
    assert timelog.counts["FUNCTION_generate_image"] == calls + 1
    assert torch.equal(tp.last_step_latents[0], nxt)
