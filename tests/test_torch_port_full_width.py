"""The port's models at their published widths, held to the JAX package.

The toy configurations of tests/toy_configs.py cannot show what only the real
shapes reach: SDXL's depth-10 transformer stacks, 2048-wide cross-attention
and pooled ``text_time`` embedding, the head dims 40/80/160 of SD 1.x and 64
of SD 2.x / XL, SD 1.x's 1x1-conv ``proj_in``, the VAE's legacy attention
names, the full CLIP text encoders and the DPT-large. Here each model runs at
full width in both packages on the same weights and the same numpy inputs,
fp32 on the CPU; the JAX side with ``use_pallas="off"``, as its own slow
tier, the port with its kernels' plain versions (CPU tensors).

Weights. Where the JAX package's whole-model golden has a torch mirror in
diffusers naming (``TorchUNet``, ``TorchControlNet``, ``TorchVAE`` of
tests/test_whole_model_goldens.py), the mirror's random state dict goes into
JAX through ``elasticdiffusion_tpu.models.convert.convert_*`` and into the
port through its checkpoint path, ``models/convert.py`` ``hf_to_port`` and
the strict ``load_into``: the path a diffusers checkpoint takes. Elsewhere
(the text encoders, the DPT) the JAX model is initialised from a seed,
every leaf moves by 0.1 N(0, 1) from a numpy seed and the tree is carried
across by ``*_from_jax``.

Bars, each the bar of the JAX test it mirrors: the VAE decoder and encoder
atol 2e-4, rtol 1e-3 (test_whole_model_goldens.py:569, :588); the UNets atol
3e-4 (SD 1.5, SD 2.1) and 1e-3 (SDXL), rtol 1e-3 (:338, :346, :374); the SD
1.5 ControlNet atol 3e-4, rtol 1e-3 on every residual (:539); the text
encoders atol 1e-4, rtol 1e-3 on the last and penultimate hidden states and
the pooled output; the DPT-large's depth within 1e-4 of its range
(tests/test_torch_port_dpt.py). Each test prints its largest absolute error
(``FULL_WIDTH`` lines; ``pytest -s`` shows them).

Tier-1 keeps the full SD VAE and the CLIP ViT-L/14 (each under a minute and
a few GB in one process); the rest is ``slow``:
    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_port_full_width.py -m slow -s
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_whole_model_goldens import TorchControlNet, TorchUNet, TorchVAE
from torch_port_common import (max_abs, perturb_tree, port_config, report,
                               t2n)

from elasticdiffusion_tpu import configs as jcfg
from elasticdiffusion_tpu.models import convert as jconvert
from elasticdiffusion_tpu.models.clip import CLIPTextModel as JCLIP
from elasticdiffusion_tpu.models.controlnet import ControlNet as JControlNet
from elasticdiffusion_tpu.models.dpt import (DPTDepthConfig as JDPTConfig,
                                             DPTDepthModel as JDPT)
from elasticdiffusion_tpu.models.unet import UNet2DCondition as JUNet
from elasticdiffusion_tpu.models.vae import AutoencoderKL as JVAE
from elasticdiffusion_tpu_torch import configs as tcfg
from elasticdiffusion_tpu_torch.models.clip import CLIPTextModel
from elasticdiffusion_tpu_torch.models.controlnet import ControlNet
from elasticdiffusion_tpu_torch.models.convert import (
    clip_from_jax, dpt_from_jax, hf_to_port, load_into)
from elasticdiffusion_tpu_torch.models.dpt import DPTDepthConfig, DPTDepthModel
from elasticdiffusion_tpu_torch.models.unet import UNet2DCondition
from elasticdiffusion_tpu_torch.models.vae import AutoencoderKL


def build_empty(cls, *args):
    """A port module with uninitialised CPU storage: every tensor is
    overwritten by the strict ``load_into`` that follows."""
    with torch.device("meta"):
        m = cls(*args)
    return m.to_empty(device="cpu").eval()


def port_from_mirror(cls, cfg, sd, kind):
    """The port's model of `cls` with a diffusers state dict, through the
    checkpoint path."""
    m = build_empty(cls, cfg)
    load_into(m, hf_to_port(sd, kind), kind)
    return m


def _np_sd_of(sd):
    return {k: v.detach().numpy() for k, v in sd.items()}


def assert_close(name, got, want, atol, rtol=1e-3):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    assert np.isfinite(got).all(), name
    err = max_abs(got, want)
    report(name, err, f"atol {atol} rtol {rtol}")
    np.testing.assert_allclose(got, want, atol=atol, rtol=rtol, err_msg=name)


# ---------------------------------------------------------------------------
# the SD VAE (tier-1)
# ---------------------------------------------------------------------------

_LEGACY = {"to_q": "query", "to_k": "key", "to_v": "value",
           "to_out.0": "proj_attn"}


def _legacy_names(sd):
    """The mid blocks' attention under the names of older diffusers VAE
    checkpoints (query, key, value, proj_attn)."""
    out = {}
    for k, v in sd.items():
        for new, old in _LEGACY.items():
            if ".attentions.0." in k and f".{new}." in k:
                k = k.replace(f".{new}.", f".{old}.")
        out[k] = v
    return out


@pytest.fixture(scope="module")
def vae_pair():
    """The mirror's state dict under both naming schemes, each carried into
    both packages: {names: (JAX params, port VAE)}."""
    cfg = jcfg.VAEConfig()
    torch.manual_seed(12)
    sd = TorchVAE(cfg).eval().state_dict()
    tc = port_config(cfg, tcfg.VAEConfig)
    out = {}
    for names, d in (("diffusers", sd), ("legacy", _legacy_names(sd))):
        out[names] = (jconvert.convert_vae(_np_sd_of(d), cfg),
                      port_from_mirror(AutoencoderKL, tc, d, "vae"))
    assert any(".proj_attn." in k for k in _legacy_names(sd))
    return cfg, out


@pytest.mark.parametrize("hw,names", [(8, "diffusers"), (16, "legacy")],
                         ids=["latent8", "latent16_legacy_names"])
def test_full_sd_vae_decoder(vae_pair, hw, names):
    """The complete SD VAE decoder (128/256/512/512; the mid block's
    attention at head dim 512 over hw^2 tokens): latent hw x hw -> 8hw x 8hw
    RGB."""
    cfg, pairs = vae_pair
    params, tvae = pairs[names]
    z = np.random.default_rng(hw).standard_normal(
        (1, cfg.latent_channels, hw, hw)).astype(np.float32)
    jvae = JVAE(cfg, use_pallas="off")
    want = jvae.apply({"params": params}, jnp.asarray(z), method=jvae.decode)
    with torch.no_grad():
        got = t2n(tvae.decode(torch.from_numpy(z)))
    assert got.shape == (1, 3, 8 * hw, 8 * hw)
    assert_close(f"vae_decoder_{hw}_{names}", got, want, atol=2e-4)


def test_full_sd_vae_encoder_moments(vae_pair):
    """The complete SD VAE encoder: 64x64 RGB -> the latent's mean and
    clamped log-variance (the background strips' encode)."""
    cfg, pairs = vae_pair
    params, tvae = pairs["diffusers"]
    x = np.random.default_rng(16).uniform(
        -1, 1, (1, cfg.in_channels, 64, 64)).astype(np.float32)
    jvae = JVAE(cfg, use_pallas="off")
    jmean, jlogvar = jvae.apply({"params": params}, jnp.asarray(x),
                                method=jvae.encode_moments)
    with torch.no_grad():
        mean, logvar = tvae.encode_moments(torch.from_numpy(x))
    assert mean.shape == (1, cfg.latent_channels, 8, 8)
    assert_close("vae_encoder_mean", t2n(mean), jmean, atol=2e-4)
    assert_close("vae_encoder_logvar", t2n(logvar), jlogvar, atol=2e-4)


@pytest.mark.parametrize("shape", [(1, 256, 512, 128), (1, 32, 64, 512)],
                         ids=["vae_up_block_3", "vae_mid_block"])
def test_plain_group_norm_is_as_exact_as_the_jax_package_s(shape):
    """The plain GroupNorm (the CPU path of every GroupNorm here) against a
    float64 GroupNorm at SD VAE shapes with a mean off zero, beside the JAX
    package's reference: within 2x its error (a whole group summed at once
    is 20x less exact at 1x256x512x128)."""
    from elasticdiffusion_tpu.kernels.groupnorm import reference_group_norm \
        as j_reference_group_norm
    from elasticdiffusion_tpu_torch.kernels.groupnorm import \
        reference_group_norm
    rng = np.random.default_rng(3)
    C = shape[-1]
    x = (1.5 * rng.standard_normal(shape) + 0.8).astype(np.float32)
    w = (1 + 0.1 * rng.standard_normal(C)).astype(np.float32)
    b = (0.1 * rng.standard_normal(C)).astype(np.float32)
    xg = torch.from_numpy(x).double().reshape(shape[0], -1, 32, C // 32)
    m = xg.mean(dim=(1, 3), keepdim=True)
    v = ((xg - m) ** 2).mean(dim=(1, 3), keepdim=True)
    exact = (((xg - m) / torch.sqrt(v + 1e-6)).reshape(shape)
             * torch.from_numpy(w).double() + torch.from_numpy(b).double())
    exact = t2n(exact * torch.sigmoid(exact))
    got = t2n(reference_group_norm(torch.from_numpy(x), torch.from_numpy(w),
                                   torch.from_numpy(b), 32, 1e-6, True))
    want = np.asarray(j_reference_group_norm(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), 32, 1e-6, True))
    port, jax_err = max_abs(got, exact), max_abs(want, exact)
    report(f"plain_group_norm_{'x'.join(map(str, shape))}_vs_float64", port,
           f"jax {jax_err!r} x 2")
    assert port <= 2 * jax_err, (port, jax_err)


# ---------------------------------------------------------------------------
# the CLIP text encoders (ViT-L/14 tier-1; OpenCLIP-H, both SDXL ones slow)
# ---------------------------------------------------------------------------

def _token_ids(cfg, seed):
    """Two rows of 77 ids from a seed: BOS, random tokens, EOS at 9 and at
    76 (the pooled feature's two extremes), EOS padding after it."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, cfg.eos_token_id - 1, (2, 77)).astype(np.int32)
    ids[:, 0] = cfg.eos_token_id - 1
    for row, eos in enumerate((9, 76)):
        ids[row, eos:] = cfg.eos_token_id
    return ids


def _hf_clip(cfg, seed, dtype=torch.float32):
    """A transformers CLIPTextModel (CLIPTextModelWithProjection where the
    config projects) of `cfg`'s architecture, initialised from a torch
    seed."""
    transformers = pytest.importorskip("transformers")
    hc = transformers.CLIPTextConfig(
        vocab_size=cfg.vocab_size, hidden_size=cfg.hidden_size,
        intermediate_size=cfg.intermediate_size,
        num_hidden_layers=cfg.num_layers, num_attention_heads=cfg.num_heads,
        max_position_embeddings=cfg.max_position_embeddings,
        hidden_act=cfg.hidden_act, layer_norm_eps=cfg.layer_norm_eps,
        projection_dim=cfg.projection_dim or cfg.hidden_size,
        eos_token_id=cfg.eos_token_id)
    cls = (transformers.CLIPTextModelWithProjection if cfg.projection_dim
           else transformers.CLIPTextModel)
    torch.manual_seed(seed)
    default = torch.get_default_dtype()
    torch.set_default_dtype(dtype)  # transformers builds its masks in it
    try:
        return cls(hc).eval()
    finally:
        torch.set_default_dtype(default)


@pytest.mark.parametrize("version,index,seed", [
    ("1.5", 0, 30),
    pytest.param("2.1", 0, 31, marks=pytest.mark.slow),
    pytest.param("XL1.0", 0, 32, marks=pytest.mark.slow),
    pytest.param("XL1.0", 1, 33, marks=pytest.mark.slow)],
    ids=["sd15_vit_l", "sd21_openclip_h", "sdxl_vit_l", "sdxl_bigg"])
def test_full_clip_text_encoder(version, index, seed):
    """One text encoder of a bundle at its published width: last hidden
    state, penultimate hidden state and pooled (projected for bigG) output.
    The mirror is transformers' own model, seeded, with every bias and norm
    parameter moved by 0.1 N(0, 1) (the rest keeps transformers' init
    scale); its state dict goes into JAX by convert_clip and into the port
    by its checkpoint path."""
    cfg = jcfg.get_bundle_config(version).text_encoders[index]
    ids = _token_ids(cfg, seed)
    hf = _hf_clip(cfg, seed)
    gen = torch.Generator().manual_seed(seed + 10)
    with torch.no_grad():
        for name, p in hf.named_parameters():
            if name.endswith("bias") or "norm" in name:
                p.add_(0.1 * torch.randn(p.shape, generator=gen))
    sd = hf.state_dict()
    del hf
    params = jconvert.convert_clip(_np_sd_of(sd), cfg)
    want = JCLIP(cfg).apply({"params": params}, jnp.asarray(ids))
    del params
    tm = port_from_mirror(CLIPTextModel, port_config(cfg, tcfg.CLIPTextConfig),
                          sd, "clip")
    del sd
    with torch.no_grad():
        got = tm(torch.from_numpy(ids))
    width = cfg.projection_dim or cfg.hidden_size
    assert got[2].shape == (2, width)
    for what, g, w in zip(("last", "penultimate", "pooled"), got, want):
        assert_close(f"clip_{version}_{index}_{what}", t2n(g), w, atol=1e-4)


@pytest.mark.slow
def test_every_leaf_perturbed_clip_l_is_fp32_noise_of_both_packages():
    """CLIP ViT-L/14 initialised in JAX with every leaf moved by 0.1 N(0, 1)
    (the recipe of tests/test_torch_port_perturbed.py at full width): its
    residual stream grows to hundreds, where the fp32 rounding of either
    package exceeds 1e-4. Held instead to a float64 run of transformers'
    model on the same weights: the port is no further from it than the
    JAX package is (within 1.5x) on every output."""
    cfg = jcfg.CLIP_VIT_L_14
    ids = _token_ids(cfg, 30)
    jm = JCLIP(cfg)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(ids))["params"]
    params = perturb_tree(params, np.random.default_rng(40))
    sd = clip_from_jax(params)
    want = jm.apply({"params": jax.tree.map(jnp.asarray, params)},
                    jnp.asarray(ids))
    del params
    tm = build_empty(CLIPTextModel, port_config(cfg, tcfg.CLIPTextConfig))
    tm.load_state_dict(sd)
    hf = _hf_clip(cfg, 0, torch.float64)
    hf.load_state_dict({k: v.double() for k, v in sd.items()})
    default = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        with torch.no_grad():
            o = hf(torch.from_numpy(ids).long(), output_hidden_states=True)
    finally:
        torch.set_default_dtype(default)
    with torch.no_grad():
        got = tm(torch.from_numpy(ids))
    exact = (o.last_hidden_state, o.hidden_states[-2], o.pooler_output)
    for what, g, w, e in zip(("last", "penultimate", "pooled"), got, want,
                             exact):
        e = e.numpy()
        port, jax_err = max_abs(t2n(g), e), max_abs(np.asarray(w), e)
        report(f"clip_l_every_leaf_{what}_vs_float64", port,
               f"jax {jax_err!r} x 1.5, |x| up to {float(np.abs(e).max())!r}")
        assert port <= 1.5 * jax_err, (what, port, jax_err)


# ---------------------------------------------------------------------------
# the UNets and the ControlNet (slow)
# ---------------------------------------------------------------------------

def _unet_inputs(cfg, hw, seed):
    """(latent, timestep, context, SDXL's pooled text and time ids) as
    numpy arrays from a seed."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((1, cfg.in_channels, hw, hw)).astype(np.float32)
    ctx = rng.standard_normal((1, 77, cfg.cross_attention_dim)).astype(
        np.float32)
    extra = {}
    if cfg.addition_embed_type == "text_time":
        extra = {"added_text_embeds": rng.standard_normal(
                     (1, cfg.pooled_projection_dim)).astype(np.float32),
                 "added_time_ids": np.asarray(
                     [[8. * 4 * hw, 8. * 4 * hw, 0., 0., 8. * 4 * hw,
                       8. * 4 * hw]], np.float32)}
    return x, 501.0, ctx, extra


def _run_unet(cfg, hw, seed):
    """The mirror's state dict into JAX, the JAX forward, then (the JAX
    parameters gone) the port through its checkpoint path: two fp32 copies
    of the weights at a time, not three."""
    x, t, ctx, extra = _unet_inputs(cfg, hw, seed)
    torch.manual_seed(seed)
    sd = TorchUNet(cfg).eval().state_dict()
    params = jconvert.convert_unet(_np_sd_of(sd), cfg)
    want = np.asarray(JUNet(cfg, use_pallas="off").apply(
        {"params": params}, jnp.asarray(x), jnp.float32(t), jnp.asarray(ctx),
        **{k: jnp.asarray(v) for k, v in extra.items()}))
    del params
    tm = port_from_mirror(UNet2DCondition, port_config(cfg, tcfg.UNetConfig),
                          sd, "unet")
    del sd
    with torch.no_grad():
        got = t2n(tm(torch.from_numpy(x), t, torch.from_numpy(ctx),
                     **{k: torch.from_numpy(v) for k, v in extra.items()}))
    assert got.shape == x.shape
    return got, want


@pytest.mark.slow
def test_full_sd15_unet():
    """SD 1.5 (865M parameters; head dims 40/80/160, 1x1-conv proj_in /
    proj_out) at a 32x32 latent."""
    got, want = _run_unet(jcfg.UNetConfig(), 32, 10)
    assert_close("unet_sd15", got, want, atol=3e-4)


@pytest.mark.slow
def test_full_sd21_unet():
    """SD 2.1-base (linear projection, 1024-wide cross-attention, head dim
    64) at a 16x16 latent."""
    got, want = _run_unet(jcfg.UNET_SD2, 16, 15)
    assert_close("unet_sd21", got, want, atol=3e-4)


@pytest.mark.slow
def test_full_sdxl_unet():
    """SDXL 1.0 base (2.57B parameters: depth-10 transformer stacks,
    2048-wide cross-attention, text_time with the pooled embedding) at a
    32x32 latent."""
    got, want = _run_unet(jcfg.UNET_SDXL, 32, 20)
    assert_close("unet_sdxl", got, want, atol=1e-3)


@pytest.mark.slow
def test_full_sd15_controlnet_every_residual():
    """The SD 1.5 ControlNet (down and mid twin, conditioning embedding, 13
    zero convs with random weights) at a 16x16 latent and a 128x128
    condition, conditioning scale 0.7: all 12 down residuals and the mid
    one."""
    cfg = jcfg.ControlNetConfig()
    ucfg = cfg.unet
    x, t, ctx, _ = _unet_inputs(ucfg, 16, 13)
    cond = np.random.default_rng(14).uniform(
        0, 1, (1, cfg.conditioning_channels, 128, 128)).astype(np.float32)
    torch.manual_seed(13)
    sd = TorchControlNet(cfg).eval().state_dict()
    params = jconvert.convert_controlnet(_np_sd_of(sd), ucfg)
    jdown, jmid = JControlNet(cfg, use_pallas="off").apply(
        {"params": params}, jnp.asarray(x), jnp.float32(t), jnp.asarray(ctx),
        jnp.asarray(cond), conditioning_scale=0.7)
    del params
    tc = tcfg.ControlNetConfig(
        unet=port_config(ucfg, tcfg.UNetConfig),
        **{f.name: getattr(cfg, f.name)
           for f in dataclasses.fields(tcfg.ControlNetConfig)
           if f.name != "unet"})
    tm = port_from_mirror(ControlNet, tc, sd, "controlnet")
    del sd
    with torch.no_grad():
        down, mid = tm(torch.from_numpy(x), t, torch.from_numpy(ctx),
                       torch.from_numpy(cond), conditioning_scale=0.7)
    assert len(down) == len(jdown) == 12
    for i, (g, w) in enumerate(zip(down, jdown)):  # JAX NHWC, the port NCHW
        assert_close(f"controlnet_down{i}", t2n(g),
                     np.transpose(np.asarray(w), (0, 3, 1, 2)), atol=3e-4)
    assert_close("controlnet_mid", t2n(mid),
                 np.transpose(np.asarray(jmid), (0, 3, 1, 2)), atol=3e-4)


# ---------------------------------------------------------------------------
# the DPT-large (slow)
# ---------------------------------------------------------------------------

def _perturb_affine(tree, rng):
    """Every bias and every norm scale of a JAX parameter tree moved by
    0.1 N(0, 1) (numpy); the weights keep Flax's init scale."""
    def move(path, leaf):
        leaf = np.asarray(leaf)
        if getattr(path[-1], "key", None) in ("bias", "scale"):
            return leaf + 0.1 * rng.standard_normal(leaf.shape).astype(
                np.float32)
        return leaf
    return jax.tree_util.tree_map_with_path(move, tree)


def _dpt_large(perturb, seed):
    """(JAX DPT-large, its perturbed parameters, the port's DPT-large with
    them, by ``dpt_from_jax``)."""
    jc, tc = JDPTConfig(), DPTDepthConfig()
    assert (jc.hidden_size, jc.num_layers, jc.image_size) == (1024, 24, 384)
    jm = JDPT(jc)
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 3, 384, 384)))[
        "params"]
    params = perturb(params, np.random.default_rng(seed))
    tm = build_empty(DPTDepthModel, tc)
    tm.load_state_dict(dpt_from_jax(params, tc.reassemble_factors))
    return jm, params, tm


def _dpt_input(seed):
    return np.random.default_rng(seed).standard_normal(
        (1, 3, 384, 384)).astype(np.float32)


@pytest.mark.slow
def test_full_dpt_large_depth():
    """DPT-large (Intel/dpt-large: 24 ViT-L layers, the reassemble and
    fusion neck) on one 384x384 image, every bias and norm parameter moved
    off Flax's init: the depth map within 1e-4 of its range."""
    jm, params, tm = _dpt_large(_perturb_affine, 51)
    x = _dpt_input(50)
    want = np.asarray(jm.apply({"params": jax.tree.map(jnp.asarray, params)},
                               jnp.asarray(x)))
    del params
    with torch.no_grad():
        got = t2n(tm(torch.from_numpy(x)))
    assert got.shape == want.shape == (1, 384, 384)
    span = float(want.max() - want.min())
    assert span > 0
    err = max_abs(got, want)
    report("dpt_large_depth", err, f"1e-4 x range {span!r}")
    assert err < 1e-4 * span, (err, span)


@pytest.mark.slow
def test_every_leaf_perturbed_dpt_large_is_fp32_noise_of_both_packages():
    """DPT-large with every leaf moved by 0.1 N(0, 1): its activations grow
    by orders of magnitude through 24 layers, and the two packages' fp32
    depths part by more than 1e-4 of the range. Held instead to a float64
    run of transformers' DPTForDepthEstimation on the same weights (the
    port's names are its checkpoint keys): the port no further from it
    than the JAX package (within 1.5x)."""
    transformers = pytest.importorskip("transformers")
    jm, params, tm = _dpt_large(perturb_tree, 51)
    x = _dpt_input(50)
    want = np.asarray(jm.apply({"params": jax.tree.map(jnp.asarray, params)},
                               jnp.asarray(x)))
    del params
    c = tm.config
    hf = transformers.DPTForDepthEstimation(transformers.DPTConfig(
        hidden_size=c.hidden_size, num_hidden_layers=c.num_layers,
        num_attention_heads=c.num_heads, intermediate_size=c.intermediate_size,
        image_size=c.image_size, patch_size=c.patch_size,
        backbone_out_indices=list(c.backbone_out_indices),
        neck_hidden_sizes=list(c.neck_hidden_sizes),
        reassemble_factors=list(c.reassemble_factors),
        fusion_hidden_size=c.fusion_hidden_size,
        layer_norm_eps=c.layer_norm_eps, readout_type="project",
        is_hybrid=False)).double().eval()
    res = hf.load_state_dict({k: v.double() for k, v in tm.state_dict().items()},
                             strict=False)
    # the two modules its depth forward never runs
    assert all(k.startswith(("dpt.layernorm.",
                             "neck.fusion_stage.layers.0.residual_layer1."))
               for k in res.missing_keys), res.missing_keys
    assert res.unexpected_keys == []
    with torch.no_grad():
        got = t2n(tm(torch.from_numpy(x)))
        exact = hf(torch.from_numpy(x).double()).predicted_depth.numpy()
    port, jax_err = max_abs(got, exact), max_abs(want, exact)
    span = float(exact.max() - exact.min())
    report("dpt_large_every_leaf_vs_float64", port,
           f"jax {jax_err!r} x 1.5, range {span!r}")
    assert port <= 1.5 * jax_err, (port, jax_err)
