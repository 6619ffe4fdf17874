"""The port's apps against the JAX package's: the CLI and the ControlNet
CLI (flags, the arguments they hand to generate_image, the output
directory), the PCA score visualizer, the two Gradio demos' callbacks and
the analytic cost model.

Where an app builds a pipe, a recorder stands in for it on both sides and
the keyword arguments of every call are compared. gradio is absent on this
host: the callbacks are reached through a stand-in ``gradio`` module that
records what ``gr.Interface`` is given. The CLI also runs end to end on the
CPU at toy size from a toy checkpoint directory, and its image is held to
the same request on the same weights in every uint8 value. fp32 on the
CPU. (``VanillaLDM``, the PCA app's sampler, is held to the JAX package in
tests/test_torch_port_checkpoint.py, on the bundles both packages read from
one checkpoint.)
"""

import functools
import os
import sys
import types

import numpy as np
import pytest
import torch
from PIL import Image

import elasticdiffusion_tpu.apps.cli as jcli
import elasticdiffusion_tpu.apps.cli_controlnet as jcn
import elasticdiffusion_tpu.apps.gradio_app as jgr
import elasticdiffusion_tpu.apps.gradio_img2img as jgi
import elasticdiffusion_tpu.apps.pca_scores as jpca
import elasticdiffusion_tpu.core.pipeline as jpipe
import elasticdiffusion_tpu.utils.flops as jflops
from elasticdiffusion_tpu import configs as jconfigs
import elasticdiffusion_tpu_torch.apps.cli as tcli
import elasticdiffusion_tpu_torch.apps.cli_controlnet as tcn
import elasticdiffusion_tpu_torch.apps.gradio_app as tgr
import elasticdiffusion_tpu_torch.apps.gradio_img2img as tgi
import elasticdiffusion_tpu_torch.apps.pca_scores as tpca
import elasticdiffusion_tpu_torch.core.pipeline as tpipe
import elasticdiffusion_tpu_torch.utils.flops as tflops
from elasticdiffusion_tpu_torch import configs as tconfigs
from elasticdiffusion_tpu_torch.models.convert import save_bundle
from elasticdiffusion_tpu_torch.models.registry import load_bundle
from toy_configs import toy_bundle_config
from torch_port_common import TORCH_TOY_RUNTIME, port_bundle_config


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def _spec(parser):
    return {a.dest: (a.default, getattr(a.type, "__name__", a.type), a.nargs,
                     tuple(a.choices or ()), tuple(a.option_strings))
            for a in parser._actions}


@pytest.mark.parametrize("controlnet", [False, True])
def test_parsers_match_jax(controlnet):
    """Same dests, defaults, types, nargs, choices and option strings."""
    assert _spec(tcli.build_parser(controlnet)) == \
        _spec(jcli.build_parser(controlnet))
    opt = tcli.build_parser().parse_args(["--repaint_sampling", "false"])
    assert opt.repaint_sampling is False and opt.H == 2048


class RecordedPipe:
    """Stands in for a pipe: records what an app does to it."""

    vae_scale_factor = 8

    def __init__(self, **kwargs):
        self.made_with = kwargs
        self.seeds, self.view_configs, self.calls = [], [], []
        self.view_batch_size = None
        self.last_metrics = {"steps": 0}

    def seed_everything(self, seed):
        self.seeds.append(seed)

    def set_view_config(self, patch_size=None):
        self.view_configs.append(patch_size)

    def get_downsample_size(self, H, W):
        return H // 16, W // 16

    def generate_image(self, **kwargs):
        self.calls.append(dict(kwargs, view_batch_size=self.view_batch_size))
        return [Image.new("RGB", (8, 8), (10, 20, 30))], {}


def _same_calls(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.keys() == y.keys()
        for k in x:
            if isinstance(x[k], np.ndarray):
                np.testing.assert_array_equal(x[k], y[k])
            else:
                assert x[k] == y[k], (k, x[k], y[k])


def _scene_png(path, h=64, w=96):
    rng = np.random.default_rng(0)
    img = np.full((h, w, 3), 40, np.uint8)
    img[h // 4:h // 2, w // 3:2 * w // 3] = rng.integers(100, 255, 3)
    Image.fromarray(img).save(path)
    return str(path)


@pytest.mark.parametrize("controlnet", [False, True],
                         ids=["cli", "cli_controlnet"])
def test_cli_main_passes_the_jax_arguments(controlnet, monkeypatch, tmp_path):
    argv = ["--sd_version", "1.5", "--H", "128", "--W", "192", "--steps", "3",
            "--resampling_steps", "2", "--new_p", "0.4", "--seed", "7",
            "--prompt", "a lighthouse", "--num_sampled", "2",
            "--rrg_scale", "1500", "--tiled_decoder", "true"]
    if controlnet:
        argv += ["--controlnet_model", "canny", "--condition_image",
                 _scene_png(tmp_path / "scene.png"),
                 "--controlnet_conditioning_scale", "0.5"]
    runs = {}
    for name, mod in (("jax", jcn if controlnet else jcli),
                      ("port", tcn if controlnet else tcli)):
        made = []

        def make_pipe(opt, controlnet_model=None):
            made.append(RecordedPipe(controlnet_model=controlnet_model))
            return made[-1]

        monkeypatch.setattr(mod, "make_pipe", make_pipe)
        mod.main(argv + ["--outdir", str(tmp_path / name)])
        runs[name] = made
    (j,), (t,) = runs["jax"], runs["port"]
    assert j.made_with == t.made_with == {
        "controlnet_model": "canny" if controlnet else None}
    assert j.seeds == t.seeds == [7]
    _same_calls(j.calls, t.calls)
    if controlnet:
        assert t.calls[0]["condition_image"].shape == (1, 3, 64, 96)
        assert t.calls[0]["condition_image"].std() > 0


def test_save_outputs_follows_the_jax_contract(tmp_path):
    """results/<exp>/<timestamp>_<seed>/: numbered PNGs, the image log's
    entries (flat and nested) and args.txt, as the JAX package writes."""
    img = Image.new("RGB", (8, 8), (255, 0, 0))
    log = {"global_img": img, "inter_x0": {"t500": img, "t250": img}}
    dirs = {}
    for name, mod in (("jax", jcli), ("port", tcli)):
        opt = mod.build_parser().parse_args(
            ["--outdir", str(tmp_path / name), "--exp", "exp1", "--seed", "42"])
        dirs[name] = mod.save_outputs(opt, [img, img], log)
    t = dirs["port"]
    assert t.startswith(str(tmp_path / "port" / "exp1")) and t.endswith("_42")
    assert sorted(os.listdir(t)) == sorted(os.listdir(dirs["jax"])) == sorted(
        ["0.png", "1.png", "global_img.png", "inter_x0_t500.png",
         "inter_x0_t250.png", "args.txt"])
    with open(os.path.join(t, "args.txt")) as f:
        args_txt = f.read()
    with open(os.path.join(dirs["jax"], "args.txt")) as f:
        assert f.read().replace("/jax", "/port") == args_txt
    assert "seed: 42" in args_txt and "exp: exp1" in args_txt


TOY_CFG = port_bundle_config(toy_bundle_config(False))


def toy_checkpoint(root):
    """A seeded toy SD bundle of the port written as a diffusers
    directory; (bundle, directory)."""
    tb = load_bundle("toy", TORCH_TOY_RUNTIME, bundle_config=TOY_CFG,
                     device="cpu", seed=9)
    d = os.path.join(root, "toy_ckpt")
    save_bundle(tb, d)
    return tb, d


def test_cli_runs_end_to_end_on_the_cpu(monkeypatch, tmp_path, capsys):
    """The CLI at toy size through make_pipe(device='cpu', bundle_config=...)
    from a checkpoint directory: its PNG equals the same request on the
    same weights, and a mesh other than 1x1 raises."""
    tb, d = toy_checkpoint(str(tmp_path))
    monkeypatch.setattr(tcli, "make_pipe", functools.partial(
        tcli.make_pipe, device="cpu", bundle_config=TOY_CFG))
    argv = ["--sd_version", "toy", "--checkpoint_dir", d, "--H", "32",
            "--W", "48", "--steps", "2", "--resampling_steps", "1",
            "--fp32", "true", "--seed", "3", "--prompt", "a cat",
            "--outdir", str(tmp_path / "out")]
    save_dir = tcli.main(argv)
    assert "[metrics] {'steps': 2" in capsys.readouterr().out
    assert {"0.png", "args.txt"} <= set(os.listdir(save_dir))
    got = np.asarray(Image.open(os.path.join(save_dir, "0.png")))
    assert got.shape == (32, 48, 3)

    opt = tcli.build_parser().parse_args(argv)
    ref = tpipe.ElasticDiffusion(device="cpu", bundle=tb,
                                 runtime=tcli.runtime_config(opt),
                                 view_batch_size=opt.view_batch_size)
    ref.seed_everything(opt.seed)
    imgs, _ = ref.generate_image(**tcli.request_kwargs(opt))
    np.testing.assert_array_equal(got, np.asarray(imgs[0]))

    with pytest.raises(NotImplementedError, match="multi-GPU"):
        tcli.make_pipe(tcli.build_parser().parse_args(argv + ["--mesh", "1x2"]),
                       device="cpu", bundle_config=TOY_CFG)


# ---------------------------------------------------------------------------
# PCA scores
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(2, 4, 8, 8), (1, 4, 16, 24), (1, 3, 12, 12)])
def test_pca_to_rgb_matches_jax(shape):
    """scikit-learn's PCA in the JAX package, numpy's eigh in the port: the
    same algorithm on a tall input, within float32 rounding."""
    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    x[:, 0] *= 3.0  # distinct principal directions
    want = jpca.pca_to_rgb(x)
    got = tpca.pca_to_rgb(x)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_memory_stats_read_torch_cuda():
    if torch.cuda.is_available():
        stats = tpca.memory_stats()
        assert set(stats["cuda:0"]) == {"bytes_in_use_mb", "peak_bytes_mb",
                                        "bytes_limit_mb"}
    else:
        assert tpca.memory_stats() == {}


# ---------------------------------------------------------------------------
# Gradio demos
# ---------------------------------------------------------------------------

def test_examples_are_the_jax_table():
    assert tgr.EXAMPLES == jgr.EXAMPLES and len(tgr.EXAMPLES) == 14


@pytest.mark.parametrize("pair", [(jgr, tgr), (jgi, tgi)],
                         ids=["gradio_app", "gradio_img2img"])
def test_build_app_raises_without_gradio(pair, monkeypatch):
    monkeypatch.setitem(sys.modules, "gradio", None)
    messages = []
    for mod in pair:
        with pytest.raises(RuntimeError, match="gradio is not installed") as e:
            mod.build_app(pipe=RecordedPipe()) if mod in (jgr, tgr) \
                else mod.build_app()
        messages.append(str(e.value))
    assert messages[0] == messages[1]


def _progress_bar(it):
    return it


@pytest.fixture
def fake_gradio(monkeypatch):
    """A stand-in gradio module: widgets are inert, Interface keeps its
    arguments, Progress().tqdm is one fixed function."""
    gr = types.ModuleType("gradio")

    class Interface:
        def __init__(self, **kwargs):
            self.kwargs = kwargs
            self.fn = kwargs["fn"]

    class Progress:
        tqdm = staticmethod(_progress_bar)

    gr.Interface, gr.Progress = Interface, Progress
    for name in ("Textbox", "Slider", "Number", "Checkbox", "Gallery", "Image",
                 "Dropdown"):
        setattr(gr, name, lambda *a, **k: None)
    monkeypatch.setitem(sys.modules, "gradio", gr)
    return gr


def _recording_pipes(monkeypatch, module):
    made = []

    def make(**kwargs):
        made.append(RecordedPipe(**kwargs))
        return made[-1]

    monkeypatch.setattr(module, "ElasticDiffusion", make)
    return made


def test_text2img_callback_matches_jax(fake_gradio, monkeypatch):
    """rrg_stop_t 0.4, keep percentage -> new_p, the live view_batch_size and
    set_view_config of every call, a new pipe when low_vram changes."""
    requests = [
        ("a cat", "blurry", 1024, 768, 7, 0.25, 1000, 10.0, 10.0, 12, 30, 96,
         5, False, True),
        ("a dog", "", 512, 512, 0, 0.3, 0, 7.5, 3.0, 16, 20, None, 1, True,
         False),
    ]
    runs = {}
    for name, app, pipe_mod in (("jax", jgr, jpipe), ("port", tgr, tpipe)):
        made = _recording_pipes(monkeypatch, pipe_mod)
        first = RecordedPipe()
        demo, port = app.build_app(sd_version="1.5", checkpoint_dir="ckpt",
                                   pipe=first)
        assert port == 7860 and demo.kwargs["examples"] == jgr.EXAMPLES
        for r in requests:
            demo.fn(*r)
        runs[name] = (first, made)
    (jfirst, jmade), (tfirst, tmade) = runs["jax"], runs["port"]
    assert [p.made_with for p in jmade] == [p.made_with for p in tmade] == [
        {"sd_version": "1.5", "checkpoint_dir": "ckpt", "low_vram": True}]
    for a, b in ((jfirst, tfirst), (jmade[0], tmade[0])):
        assert a.seeds == b.seeds and a.view_configs == b.view_configs
        _same_calls(a.calls, b.calls)
    assert tfirst.calls[0]["rrg_stop_t"] == 0.4
    assert tfirst.calls[0]["new_p"] == 0.25
    assert tfirst.calls[0]["view_batch_size"] == 12
    assert tfirst.view_configs == [96] and tmade[0].view_configs == [None]
    assert tfirst.calls[0]["progress"] is _progress_bar


def test_img2img_callback_matches_jax(fake_gradio, monkeypatch):
    """The condition at the downsampled size times 8, the ControlNet scale,
    and the pipe cache keyed on (condition, low_vram)."""
    image = np.random.default_rng(3).integers(0, 256, (40, 56, 3)).astype(
        np.uint8)
    requests = [(c, lv) for c, lv in (("canny", False), ("canny", False),
                                      ("canny", True))]
    runs = {}
    for name, app, pipe_mod in (("jax", jgi, jpipe), ("port", tgi, tpipe)):
        made = _recording_pipes(monkeypatch, pipe_mod)
        demo, port = app.build_app(sd_version="XL1.0", checkpoint_dir=None)
        assert port == 7861
        for cond, low_vram in requests:
            demo.fn(image, "a house", "blurry", cond, 0.6, 512, 768, 7, 0.3,
                    2000, 10.0, 10.0, 16, 30, 4, low_vram, False)
        runs[name] = made
    j, t = runs["jax"], runs["port"]
    assert [p.made_with for p in j] == [p.made_with for p in t] == [
        {"sd_version": "XL1.0", "checkpoint_dir": None,
         "controlnet_model": "canny", "low_vram": lv} for lv in (False, True)]
    for a, b in zip(j, t):
        assert a.seeds == b.seeds
        _same_calls(a.calls, b.calls)
    cond = t[0].calls[0]["condition_image"]
    assert cond.shape == (1, 3, 384, 256) and len(t[0].calls) == 2


# ---------------------------------------------------------------------------
# flops
# ---------------------------------------------------------------------------

def _cfg_pair(version):
    if version == "toy":
        jc = toy_bundle_config(False)
        return jc, port_bundle_config(jc)
    if version == "toy-xl":
        jc = toy_bundle_config(True)
        return jc, port_bundle_config(jc)
    return jconfigs.get_bundle_config(version), tconfigs.get_bundle_config(version)


@pytest.mark.parametrize("version,hw", [
    (v, hw) for v in ("1.5", "2.1", "XL1.0")
    for hw in ((512, 512), (1024, 1024), (1024, 2048))]
    + [("toy", (16, 24)), ("toy-xl", (16, 16))])
def test_flops_match_jax(version, hw):
    jc, tc = _cfg_pair(version)
    f = jc.vae.scale_factor
    h, w = hw[0] // f, hw[1] // f
    assert tflops.unet_stage_costs(tc.unet, h, w) == \
        jflops.unet_stage_costs(jc.unet, h, w)
    assert tflops.unet_stage_flops(tc.unet, h, w, 64) == \
        jflops.unet_stage_flops(jc.unet, h, w, 64)
    assert tflops.unet_forward_flops(tc.unet, h, w) == \
        jflops.unet_forward_flops(jc.unet, h, w)
    assert tflops.controlnet_costs(
        tconfigs.ControlNetConfig(unet=tc.unet, cond_downsample_factor=f), h, w) \
        == jflops.controlnet_costs(
            jconfigs.ControlNetConfig(unet=jc.unet, cond_downsample_factor=f), h, w)
    for bpe in (2, 4):
        assert tflops.vae_decoder_costs(tc.vae, h, w, bpe) == \
            jflops.vae_decoder_costs(jc.vae, h, w, bpe)
    cost = tflops.unet_stage_costs(tc.unet, h, w)["mid"]
    assert tflops.roofline_seconds(cost, 8, 197.0, 819.0) == \
        jflops.roofline_seconds(cost, 8, 197.0, 819.0)


def test_roofline_defaults_are_the_h100_datasheet_peaks():
    assert (tflops.H100_BF16_TFLOPS, tflops.H100_FP32_TFLOPS,
            tflops.H100_HBM_GBPS) == (989.0, 67.0, 3350.0)
    cost = {"flops": 989e12, "param_bytes": 0, "act_bytes": 0}
    r = tflops.roofline_seconds(cost, 1)
    assert r["compute_s"] == 1.0 and r["bound"] == "compute"
    import chip_smoke
    assert chip_smoke.PEAK_BYTES_PER_S == 3.35e12
    assert chip_smoke.PEAK_OPS_PER_S == {torch.bfloat16: 989e12,
                                         torch.float32: 67e12}
