"""Loading checkpoints into the port, held to the JAX package reading the
same files.

The port's toy SDXL bundle with a ControlNet (two text encoders), every
parameter moved off its seeded init by 0.1 N(0, 1) from a numpy seed, is
written as a diffusers pipeline directory (``save_bundle``) in two variants:
fp32, and fp16 with the VAE's legacy attention names (``query``, ``key``,
``value``, ``proj_attn``) and 1x1-conv shaped attention weights. The JAX
package's own ``convert_checkpoint`` turns each into its converted ``.npz``
directory: it reads diffusers names, so it is the independent witness that
the port's names are those (the ControlNet's too: the JAX side converts it
and the port's readers must give back every tensor of it, but only the
UNet, VAE and CLIP forwards are run on the JAX side). Then the JAX ``load_bundle(checkpoint_dir=npz)``
is held to the port's ``load_bundle`` reading the diffusers directory and
reading the ``.npz`` directory (for the fp16 variant, the JAX side reads
the trees with its ``load_converted_params`` and casts them to fp32 as its
``load_bundle`` does, into the bundle object of the fp32 variant, so that
nothing is initialised or compiled twice).

Bars: 3e-5 for the models (those of tests/test_torch_port_perturbed.py),
per-step latent MAE < 1e-3 (max < 1e-2) for ``generate_image``; the DPT
against transformers within 1e-4 of the largest depth. fp32 on the CPU.
"""

import contextlib
import functools
import os
import re
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.torch import load_file, save_file

from elasticdiffusion_tpu.models.convert import (convert_checkpoint,
                                                load_converted_params)
from elasticdiffusion_tpu.models.registry import load_bundle as j_load_bundle
from elasticdiffusion_tpu_torch.apps import preprocessors as tpre
from elasticdiffusion_tpu_torch.models import dpt as tdpt
from elasticdiffusion_tpu_torch.models.convert import hf_to_port, save_bundle
from elasticdiffusion_tpu_torch.models.registry import load_bundle
from toy_configs import TOY_RUNTIME, toy_bundle_config
from torch_port_common import (TORCH_TOY_RUNTIME, max_abs,
                               pipeline_parity_run, port_bundle_config, t2n)

TOL = 3e-5
JCFG = toy_bundle_config(xl=True)
TCFG = port_bundle_config(JCFG)
VARIANTS = ("fp32", "fp16_legacy")
READERS = ("diffusers", "npz")


def _port_bundle(**kw):
    return load_bundle("toy-xl", TORCH_TOY_RUNTIME, bundle_config=TCFG,
                       controlnet_model="canny", device="cpu", **kw)


@functools.lru_cache(maxsize=1)
def source_bundle():
    """The port's toy bundle with every parameter perturbed."""
    tb = _port_bundle(seed=5)
    rng = np.random.default_rng(30)
    with torch.no_grad():
        for m in (tb.unet, tb.vae_fp32, *tb.text_models, tb.controlnet):
            for p in m.parameters():
                p.add_(torch.from_numpy(
                    0.1 * rng.standard_normal(p.shape).astype(np.float32)))
    return tb


_LEGACY = {"to_q": "query", "to_k": "key", "to_v": "value",
           "to_out.0": "proj_attn"}


def _fp16_legacy(src: str, dst: str) -> None:
    """A copy of a diffusers directory in fp16, with the VAE's attention
    under its legacy names and its weights 1x1-conv shaped."""
    shutil.copytree(src, dst)
    for root, _, files in os.walk(dst):
        for f in files:
            path = os.path.join(root, f)
            out = {}
            for k, v in load_file(path).items():
                v = v.half()
                m = re.fullmatch(r"(.*\.attentions\.0)\.(to_q|to_k|to_v|to_out\.0)"
                                 r"\.(weight|bias)", k)
                if os.path.basename(root) == "vae" and m:
                    k = f"{m.group(1)}.{_LEGACY[m.group(2)]}.{m.group(3)}"
                    if m.group(3) == "weight":
                        v = v[:, :, None, None]
                out[k] = v.contiguous()
            save_file(out, path)


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    """{variant: {'diffusers': dir, 'npz': dir}}."""
    root = tmp_path_factory.mktemp("checkpoints")
    out = {}
    for variant in VARIANTS:
        hf = str(root / variant / "hf")
        if variant == "fp32":
            save_bundle(source_bundle(), hf)
        else:
            _fp16_legacy(out["fp32"]["diffusers"], hf)
        npz = str(root / variant / "npz")
        convert_checkpoint(hf, npz, JCFG,
                           controlnet_src=os.path.join(hf, "controlnet"))
        out[variant] = {"diffusers": hf, "npz": npz}
    return out


@functools.lru_cache(maxsize=4)
def port_loaded(checkpoint_dir: str):
    return _port_bundle(seed=6, checkpoint_dir=checkpoint_dir)


@functools.lru_cache(maxsize=1)
def _jax_loaded(npz_dir: str):
    """The JAX package's load_bundle of a converted directory, and its
    parameter trees as device arrays: the bundle keeps host-side text
    parameters in a cache of its own, which a swap would leave stale."""
    jb = j_load_bundle("toy-xl", TOY_RUNTIME, checkpoint_dir=npz_dir,
                       bundle_config=JCFG)
    return jb, {"unet_params": jb.unet_params, "vae_params": jb.vae_params,
                "text_params": jax.tree.map(jnp.asarray, jb.text_params)}


@functools.lru_cache(maxsize=1)
def _jax_params(npz_dir: str):
    """A converted directory's trees read by the JAX package's
    load_converted_params and cast to fp32, as its load_bundle casts a toy
    runtime's parameters."""
    loaded = {k: jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), v)
              for k, v in load_converted_params(npz_dir).items()}
    return {"unet_params": loaded["unet"], "vae_params": loaded["vae"],
            "text_params": (loaded["text_encoder_0"],
                            loaded["text_encoder_1"])}


@contextlib.contextmanager
def jax_bundle(ckpts, variant: str):
    """The JAX bundle that load_bundle read from the fp32 variant's npz
    directory; for the fp16 variant, the same bundle object with that
    variant's trees swapped in while the block runs (its jitted forwards
    take the parameters as arguments, so nothing is compiled twice)."""
    jb, saved = _jax_loaded(ckpts["fp32"]["npz"])
    params = saved if variant == "fp32" else _jax_params(ckpts[variant]["npz"])
    for k, v in params.items():
        setattr(jb, k, v)
    try:
        yield jb
    finally:
        for k, v in saved.items():
            setattr(jb, k, v)


def _modules(b):
    return {"unet": b.unet, "vae": b.vae_fp32, "controlnet": b.controlnet,
            **{f"text_encoder_{i}": m for i, m in enumerate(b.text_models)}}


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("reader", READERS)
def test_readers_load_the_written_weights(ckpts, variant, reader):
    """Both readers give every tensor of the source bundle, through fp16
    where the files are fp16, into modules that keep their fp32 dtype."""
    src, got = _modules(source_bundle()), _modules(port_loaded(ckpts[variant][reader]))
    for name, module in src.items():
        want = module.state_dict()
        have = got[name].state_dict()
        assert have.keys() == want.keys(), name
        for k, w in want.items():
            if variant != "fp32":
                w = w.half().float()
            assert have[k].dtype == torch.float32
            assert torch.equal(have[k], w), (name, k)


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("reader", READERS)
def test_unet_matches_jax(ckpts, variant, reader):
    tb = port_loaded(ckpts[variant][reader])
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 4, 8, 8)).astype(np.float32)
    ctx = rng.standard_normal((3, 77, 40)).astype(np.float32)
    pooled = rng.standard_normal((3, 24)).astype(np.float32)
    tids = np.tile(np.asarray([[64., 96., 0., 0., 64., 96.]], np.float32), (3, 1))
    with jax_bundle(ckpts, variant) as jb:
        want = np.asarray(jb.apply_unet(
            jnp.asarray(x), jnp.float32(500.0), jnp.asarray(ctx),
            added_text_embeds=jnp.asarray(pooled),
            added_time_ids=jnp.asarray(tids)))
    got = t2n(tb.apply_unet(torch.from_numpy(x), 500.0, torch.from_numpy(ctx),
                            added_text_embeds=torch.from_numpy(pooled),
                            added_time_ids=torch.from_numpy(tids)))
    assert max_abs(got, want) < TOL, max_abs(got, want)


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("reader", READERS)
@pytest.mark.parametrize("which", ["decode", "encode"])
def test_vae_matches_jax(ckpts, variant, reader, which):
    tb = port_loaded(ckpts[variant][reader])
    rng = np.random.default_rng(1)
    with jax_bundle(ckpts, variant) as jb:
        if which == "decode":
            z = rng.standard_normal((1, 4, 6, 8)).astype(np.float32)
            want = np.asarray(jb.vae_decode(jnp.asarray(z)))
            got = t2n(tb.vae_decode(torch.from_numpy(z)))
        else:
            img = rng.uniform(-1, 1, (1, 3, 12, 16)).astype(np.float32)
            nz = rng.standard_normal((1, 4, 6, 8)).astype(np.float32)
            want = np.asarray(jb.vae_encode_sample(jnp.asarray(img),
                                                   jnp.asarray(nz)))
            got = t2n(tb.vae_encode_sample(torch.from_numpy(img),
                                           torch.from_numpy(nz)))
    assert max_abs(got, want) < TOL, max_abs(got, want)


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("reader", READERS)
@pytest.mark.parametrize("encoder", [0, 1])
def test_clip_matches_jax(ckpts, variant, reader, encoder):
    tb = port_loaded(ckpts[variant][reader])
    prompt = ["a photo of a lighthouse, at dusk"]
    with jax_bundle(ckpts, variant) as jb:
        ids = jb.tokenizers[encoder](prompt)
        want = jb.encode_text(ids, encoder)
    got = tb.encode_text(tb.tokenizers[encoder](prompt), encoder)
    for g, w in zip(got, want):
        assert max_abs(t2n(g), np.asarray(w)) < TOL


def test_generate_image_matches_jax(ckpts, monkeypatch, tmp_path):
    """One short elastic run of the diffusers-read bundle against the JAX
    bundle read from the converted files."""
    with jax_bundle(ckpts, "fp32") as jb:
        _, _, jimg, jlats, timg, _, tlats = pipeline_parity_run(
            jb, port_loaded(ckpts["fp32"]["diffusers"]), monkeypatch, tmp_path,
            repaint=False, rrg=False, rs=1, steps=2)
    assert len(jlats) == len(tlats) == 2
    for i, (a, b) in enumerate(zip(tlats, jlats)):
        d = np.abs(a - b)
        assert d.mean() < 1e-3 and d.max() < 1e-2, (i, d.mean(), d.max())
    assert np.abs(timg - jimg).max() < 1e-2


def test_vanilla_ldm_matches_jax(ckpts, monkeypatch):
    """The PCA app's sampler on both loaded bundles (SDXL's added
    conditioning included), from the same latent: the JAX side's draw is
    replaced in the test. The final image and the logged x0 decodes within
    1e-3; the PCA images' shapes."""
    from elasticdiffusion_tpu.apps.pca_scores import VanillaLDM as JVanilla
    from elasticdiffusion_tpu_torch.apps.pca_scores import VanillaLDM
    init = np.random.default_rng(2).standard_normal((1, 4, 8, 8)).astype(
        np.float32)
    draw = jax.random.normal

    def normal(key, shape, dtype=jnp.float32):
        return jnp.asarray(init) if tuple(shape) == init.shape \
            else draw(key, shape, dtype)

    kw = dict(prompts="a photo of a cat", negative_prompts="", height=16,
              width=16, num_inference_steps=3, guidance_scale=7.5, seed=0)
    with jax_bundle(ckpts, "fp32") as jb:
        monkeypatch.setattr(jax.random, "normal", normal)
        jimg, jlogs = JVanilla(bundle=jb, log_freq=2).generate_image(**kw)
        monkeypatch.undo()
    timg, tlogs = VanillaLDM(
        device="cpu", bundle=port_loaded(ckpts["fp32"]["diffusers"]),
        log_freq=2).generate_image(latents=init, **kw)
    assert timg.shape == np.asarray(jimg).shape == (1, 3, 16, 16)
    assert max_abs(timg, jimg) < 1e-3, max_abs(timg, jimg)
    assert len(tlogs["inter_x0"]) == len(jlogs["inter_x0"]) == 2
    for a, b in zip(tlogs["inter_x0"], jlogs["inter_x0"]):
        assert max_abs(a, b) < 1e-3, max_abs(a, b)
    for k in ("direction_pca", "uncond_pca"):
        assert [a.shape for a in tlogs[k]] == [(1, 3, 8, 8)] * 2


def _broken_copy(ckpts, tmp_path, change):
    """The fp32 diffusers directory with the UNet's file changed."""
    d = str(tmp_path / "ckpt")
    shutil.copytree(ckpts["fp32"]["diffusers"], d)
    path = os.path.join(d, "unet", "diffusion_pytorch_model.safetensors")
    sd = load_file(path)
    change(sd)
    save_file(sd, path)
    return d


KEY = "down_blocks.1.attentions.0.transformer_blocks.0.attn1.to_k.weight"


@pytest.mark.parametrize("change,match", [
    (lambda sd: sd.pop(KEY), "missing keys 1 .*" + re.escape(KEY)),
    (lambda sd: sd.update({"mid_block.extra.weight": torch.zeros(2)}),
     r"unexpected keys 1 .*mid_block\.extra\.weight"),
    (lambda sd: sd.update({KEY: torch.zeros(3, 3)}),
     re.escape(KEY) + r" has shape \(3, 3\) in the checkpoint"),
], ids=["missing", "extra", "shape"])
def test_strict_loading_names_the_key(ckpts, tmp_path, change, match):
    d = _broken_copy(ckpts, tmp_path, change)
    with pytest.raises(ValueError, match=match) as e:
        _port_bundle(checkpoint_dir=d)
    assert "unet in " + d in str(e.value)


def test_an_absent_model_keeps_its_seeded_init(ckpts, tmp_path):
    d = str(tmp_path / "ckpt")
    shutil.copytree(ckpts["fp32"]["diffusers"], d)
    shutil.rmtree(os.path.join(d, "vae"))
    with pytest.warns(UserWarning, match="no weights for vae"):
        got = _port_bundle(seed=6, checkpoint_dir=d)
    seeded = _port_bundle(seed=6)
    for a, b in zip(got.vae_fp32.parameters(), seeded.vae_fp32.parameters()):
        assert torch.equal(a, b)
    src = source_bundle()
    for a, b in zip(got.unet.parameters(), src.unet.parameters()):
        assert torch.equal(a, b)
    with pytest.raises(FileNotFoundError, match="/nowhere"):
        _port_bundle(checkpoint_dir="/nowhere")
    with pytest.raises(FileNotFoundError, match="neither"):
        _port_bundle(checkpoint_dir=str(tmp_path))


def test_fp16_files_take_the_runtime_dtypes(ckpts):
    """UNet, text encoders and ControlNet in the parameter dtype, the VAE's
    master in fp32 and its compute copy's matrices in bf16 (norms fp32)."""
    from elasticdiffusion_tpu_torch.configs import RuntimeConfig
    d = ckpts["fp16_legacy"]["diffusers"]
    tb = load_bundle("toy-xl", RuntimeConfig(), bundle_config=TCFG,
                     controlnet_model="canny", device="cpu", checkpoint_dir=d)
    for m in (tb.unet, tb.controlnet, *tb.text_models):
        assert {p.dtype for p in m.parameters()} == {torch.bfloat16}
    assert {p.dtype for p in tb.vae_fp32.parameters()} == {torch.float32}
    src = source_bundle()
    for (k, a), b in zip(tb.vae_fp32.state_dict().items(),
                         src.vae_fp32.state_dict().values()):
        assert torch.equal(a, b.half().float()), k
    w = tb.vae.decoder.conv_in.weight
    assert w.dtype == torch.bfloat16
    assert torch.equal(w, tb.vae_fp32.decoder.conv_in.weight.bfloat16())
    assert tb.vae.decoder.conv_norm_out.weight.dtype == torch.float32
    for a, b in zip(tb.unet.parameters(), src.unet.parameters()):
        assert torch.equal(a, b.half().bfloat16())


def test_npz_reader_and_torch_pickles(ckpts, tmp_path):
    """The port's own npz reader gives the JAX package's trees; a model
    stored as a torch pickle (``.bin``) loads like its safetensors file."""
    from elasticdiffusion_tpu_torch.models import convert as tconvert
    npz = ckpts["fp16_legacy"]["npz"]
    want = load_converted_params(npz)
    got = tconvert.load_converted_params(npz)
    assert got.keys() == want.keys()
    for name in want:
        w = dict(jax.tree_util.tree_flatten_with_path(want[name])[0])
        g = dict(jax.tree_util.tree_flatten_with_path(got[name])[0])
        assert g.keys() == w.keys()
        for k in w:
            assert g[k].dtype == w[k].dtype and np.array_equal(g[k], w[k])
    d = str(tmp_path / "ckpt")
    shutil.copytree(ckpts["fp32"]["diffusers"], d)
    st = os.path.join(d, "unet", "diffusion_pytorch_model.safetensors")
    torch.save(load_file(st), os.path.join(d, "unet",
                                           "diffusion_pytorch_model.bin"))
    os.remove(st)
    got = _port_bundle(seed=6, checkpoint_dir=d)
    for a, b in zip(got.unet.state_dict().values(),
                    source_bundle().unet.state_dict().values()):
        assert torch.equal(a, b)


def test_hf_to_port_rules():
    sd = {"text_model.embeddings.position_ids": torch.arange(77)[None],
          "encoder.mid_block.attentions.0.query.weight": torch.ones(4, 4, 1, 1),
          "encoder.mid_block.attentions.0.proj_attn.bias": torch.ones(4),
          "mid_block.attentions.0.proj_in.weight": torch.ones(4, 4, 1, 1),
          "dpt.layernorm.weight": torch.ones(4)}
    assert set(hf_to_port(sd, "clip")) == set(sd) - {
        "text_model.embeddings.position_ids"}
    vae = hf_to_port(sd, "vae")
    assert vae["encoder.mid_block.attentions.0.to_q.weight"].shape == (4, 4)
    assert "encoder.mid_block.attentions.0.to_out.0.bias" in vae
    # SD 1.x proj_in / proj_out stay 1x1 convolutions
    assert vae["mid_block.attentions.0.proj_in.weight"].shape == (4, 4, 1, 1)
    assert "dpt.layernorm.weight" not in hf_to_port(sd, "dpt")
    with pytest.raises(ValueError, match="kind"):
        hf_to_port(sd, "tokenizer")


def save_tiny_transformers_dpt(path):
    """A tiny transformers DPTForDepthEstimation, its parameters moved off
    their init, written with save_pretrained; returns the model."""
    import transformers
    cfg = transformers.DPTConfig(
        hidden_size=32, num_hidden_layers=4, num_attention_heads=2,
        intermediate_size=64, image_size=64, patch_size=16,
        backbone_out_indices=[0, 1, 2, 3], neck_hidden_sizes=[16, 24, 32, 32],
        fusion_hidden_size=24, readout_type="project", is_hybrid=False,
        hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    torch.manual_seed(0)
    hf = transformers.DPTForDepthEstimation(cfg).eval()
    with torch.no_grad():
        for p in hf.parameters():
            p.add_(0.1 * torch.randn(p.shape))
    hf.save_pretrained(str(path))
    return hf


def test_load_dpt_matches_transformers(tmp_path):
    hf = save_tiny_transformers_dpt(tmp_path)
    tm = tdpt.load_dpt(str(tmp_path), device="cpu")
    assert tm.config.num_layers == 4 and tm.config.image_size == 64
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (1, 3, 64, 64)).astype(np.float32))
    with torch.no_grad():
        want = hf(x).predicted_depth.numpy()
        got = tm(x).numpy()
    rel = float(np.abs(got - want).max() / np.abs(want).max())
    assert rel < 1e-4, rel


def test_default_depth_fn_reads_ed_dpt_dir(tmp_path, monkeypatch):
    """With ED_DPT_DIR set, default_depth_fn is make_depth_fn of the DPT that
    load_dpt reads from it (placed on the CPU here)."""
    save_tiny_transformers_dpt(tmp_path)
    load_dpt, seen = tdpt.load_dpt, []

    def on_cpu(model_dir, device="cuda"):
        seen.append(model_dir)
        return load_dpt(model_dir, device="cpu")

    monkeypatch.setattr(tdpt, "load_dpt", on_cpu)
    monkeypatch.setattr(tpre, "_builtin_depth_fn", None)
    monkeypatch.setenv("ED_DPT_DIR", str(tmp_path))
    monkeypatch.delenv("ED_DPT_ALLOW_RANDOM", raising=False)
    fn = tpre.default_depth_fn()
    assert seen == [str(tmp_path)] and tpre.default_depth_fn() is fn
    img = np.random.default_rng(5).integers(0, 256, (40, 56, 3)).astype(np.uint8)
    want = tdpt.make_depth_fn(load_dpt(str(tmp_path), device="cpu"),
                              proc_size=384)(img)
    np.testing.assert_array_equal(fn(img), want)
