"""A run driven on the CPU at toy size, the look for a chip skipped: sound,
it comes out correct; with the timed path broken underneath, it does not.
The faults a cell of this benchmark can have: a step that returns its
state unchanged, half of a UNet batch left out (the other half's rows in
its place), an answer altered where it is produced. One chip: no exchange
between chips to leave out."""

import pytest
import torch

import toy
from portbench.run import run_cell


def _run(kind="sd2"):
    return run_cell(toy.cell(kind), 77, 0.01, False, device="cpu", t0=0.0,
                    metric_names=["image_s"])


def test_sound_run_is_correct():
    r = _run()
    assert r["correct"], r["checks"]
    assert list(r)[-1] == "checks"


def _step_unchanged(monkeypatch):
    from elasticdiffusion_tpu_torch.core.pipeline import ElasticDiffusion
    orig = ElasticDiffusion._denoise_step
    monkeypatch.setattr(ElasticDiffusion, "_denoise_step",
                        lambda self, ctx, lat, inp, rp: (lat, orig(self, ctx, lat, inp, rp)[1]))


def _half_batch(monkeypatch):
    from elasticdiffusion_tpu_torch.models.registry import ModelBundle
    orig = ModelBundle.apply_unet

    def half(self, x, t, ctx, **kw):
        n = (x.shape[0] + 1) // 2
        keep = lambda a: None if a is None else a[:n]
        out = orig(self, x[:n], t, ctx[:n], **{k: keep(v) for k, v in kw.items()})
        return torch.cat([out, out])[:x.shape[0]]
    monkeypatch.setattr(ModelBundle, "apply_unet", half)


def _image_altered(monkeypatch):
    from elasticdiffusion_tpu_torch.core.pipeline import ElasticDiffusion
    orig = ElasticDiffusion.decode_latents
    monkeypatch.setattr(ElasticDiffusion, "decode_latents",
                        lambda self, lat: (orig(self, lat) + 0.05).clamp(0, 1))


@pytest.mark.parametrize("fault", [_step_unchanged, _half_batch, _image_altered])
def test_fault_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    r = _run()
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("fault", [_step_unchanged, _half_batch, _image_altered])
def test_fault_is_not_correct_in_fp32(monkeypatch, fault):
    """The same faults under a float32 configuration, whose steps are in
    TF32 units."""
    assert _run("fp32")["correct"]
    fault(monkeypatch)
    r = _run("fp32")
    assert not r["correct"], r["checks"]
