"""Toy UNet, VAE and CLIP of the port against the JAX package with shared
parameters (carried across by models/convert.py), and the bundle's entry
points. fp32 on the CPU; bars in the range tests/test_torch_goldens.py uses."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elasticdiffusion_tpu.models.convert import (
    convert_clip, convert_unet, convert_vae)
from elasticdiffusion_tpu_torch import configs as tcfg
from elasticdiffusion_tpu_torch.models.convert import (
    clip_from_jax, save_bundle, unet_from_jax, vae_from_jax)
from elasticdiffusion_tpu_torch.models.registry import load_bundle
from torch_port_common import (TORCH_TOY_RUNTIME, max_abs, port_bundle_config,
                               t2n, to_numpy_tree, toy_bundles)

TOL = 5e-5


def _rng():
    return np.random.default_rng(0)


@pytest.mark.parametrize("t", [1.0, 500.0, 981.0])
def test_toy_unet_matches_jax(t):
    jb, tb = toy_bundles()
    x = _rng().standard_normal((3, 4, 8, 8)).astype(np.float32)
    ctx = _rng().standard_normal((3, 77, 16)).astype(np.float32)
    want = jb.apply_unet(jnp.asarray(x), jnp.float32(t), jnp.asarray(ctx))
    got = tb.apply_unet(torch.from_numpy(x), t, torch.from_numpy(ctx))
    assert got.shape == (3, 4, 8, 8)
    assert max_abs(t2n(got), np.asarray(want)) < TOL


def test_toy_unet_takes_per_sample_timesteps_and_odd_sizes():
    jb, tb = toy_bundles()
    x = _rng().standard_normal((2, 4, 8, 12)).astype(np.float32)
    ctx = _rng().standard_normal((2, 77, 16)).astype(np.float32)
    t = np.asarray([10.0, 700.0], np.float32)
    want = jb.apply_unet(jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx))
    got = tb.apply_unet(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx))
    assert max_abs(t2n(got), np.asarray(want)) < TOL


@pytest.mark.parametrize("hw", [(4, 4), (6, 8)])
def test_toy_vae_decode_matches_jax(hw):
    jb, tb = toy_bundles()
    z = _rng().standard_normal((1, 4) + hw).astype(np.float32)
    want = jb.vae_decode(jnp.asarray(z))
    got = tb.vae_decode(torch.from_numpy(z))
    assert got.shape == (1, 3, 2 * hw[0], 2 * hw[1])
    assert max_abs(t2n(got), np.asarray(want)) < TOL


@pytest.mark.parametrize("hw", [(8, 8), (12, 16), (6, 16)])
def test_toy_vae_encode_sample_matches_jax(hw):
    jb, tb = toy_bundles()
    img = _rng().uniform(-1, 1, (1, 3) + hw).astype(np.float32)
    nz = _rng().standard_normal((1, 4, hw[0] // 2, hw[1] // 2)).astype(np.float32)
    want = jb.vae_encode_sample(jnp.asarray(img), jnp.asarray(nz))
    got = tb.vae_encode_sample(torch.from_numpy(img), torch.from_numpy(nz))
    assert max_abs(t2n(got), np.asarray(want)) < TOL


@pytest.mark.parametrize("prompt", ["a photo of a cat", "", "two words, and: punctuation!"])
def test_toy_clip_and_tokenizer_match_jax(prompt):
    jb, tb = toy_bundles()
    jids, tids = jb.tokenizers[0]([prompt]), tb.tokenizers[0]([prompt])
    np.testing.assert_array_equal(jids, tids)
    want = jb.encode_text(jids, 0)
    got = tb.encode_text(tids, 0)
    for g, w in zip(got, want):
        assert max_abs(t2n(g), np.asarray(w)) < TOL


def test_clip_projection_head_carries_across():
    """The SDXL second encoder's text_projection (no bias)."""
    import jax
    from toy_configs import TOY_CLIP_2
    from elasticdiffusion_tpu.models.clip import CLIPTextModel as JCLIP
    from elasticdiffusion_tpu_torch.models.clip import CLIPTextModel as TCLIP
    from torch_port_common import port_config
    ids = _rng().integers(0, 255, (2, 77)).astype(np.int32)
    jm = JCLIP(TOY_CLIP_2)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(ids))["params"]
    tm = TCLIP(port_config(TOY_CLIP_2, tcfg.CLIPTextConfig)).eval()
    tm.load_state_dict(clip_from_jax(to_numpy_tree(params)))
    want = jm.apply({"params": params}, jnp.asarray(ids))
    with torch.no_grad():
        got = tm(torch.from_numpy(ids))
    for g, w in zip(got, want):
        assert max_abs(t2n(g), np.asarray(w)) < TOL


@pytest.mark.parametrize("which", ["unet", "vae", "clip"])
def test_from_jax_inverts_the_checkpoint_converter(which):
    """state_dict keys are the diffusers / transformers checkpoint keys: the
    JAX package's own HF -> Flax converter maps them straight back."""
    jb, tb = toy_bundles()
    if which == "unet":
        tree = to_numpy_tree(jb.unet_params)
        back = convert_unet({k: v.numpy() for k, v in unet_from_jax(tree).items()},
                            jb.config.unet)
    elif which == "vae":
        tree = to_numpy_tree(jb.vae_params)
        back = convert_vae({k: v.numpy() for k, v in vae_from_jax(tree).items()},
                           jb.config.vae)
    else:
        tree = to_numpy_tree(jb.text_params[0])
        back = convert_clip({k: v.numpy() for k, v in clip_from_jax(tree).items()},
                            jb.config.text_encoders[0])
    import jax
    flat_a = jax.tree_util.tree_flatten_with_path(tree)[0]
    flat_b = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_a) == len(flat_b)
    for path, a in flat_a:
        np.testing.assert_array_equal(a, flat_b[path])


def test_full_width_state_dict_keys_follow_diffusers_names():
    """SD 2.1 and SDXL full-width UNets on the meta device: no memory."""
    from elasticdiffusion_tpu_torch.models.unet import UNet2DCondition
    with torch.device("meta"):
        sd2 = UNet2DCondition(tcfg.UNET_SD2)
        sdxl = UNet2DCondition(tcfg.UNET_SDXL)
    keys = set(sd2.state_dict())
    for k in ("conv_in.weight", "time_embedding.linear_1.weight",
              "down_blocks.0.attentions.1.transformer_blocks.0.attn2.to_k.weight",
              "down_blocks.2.downsamplers.0.conv.bias",
              "mid_block.attentions.0.proj_in.weight",
              "up_blocks.3.attentions.2.transformer_blocks.0.ff.net.0.proj.weight",
              "up_blocks.0.upsamplers.0.conv.weight", "conv_norm_out.weight"):
        assert k in keys, k
    n = sum(p.numel() for p in sd2.parameters())
    assert 8.6e8 < n < 8.7e8          # the published 866 M parameters
    assert sd2.up_blocks[1].resnets[2].conv1.weight.shape == (1280, 1920, 3, 3)
    assert "add_embedding.linear_1.weight" in sdxl.state_dict()
    assert 2.5e9 < sum(p.numel() for p in sdxl.parameters()) < 2.6e9


def test_bundle_entry_points_and_device_rule(tmp_path):
    jb, tb = toy_bundles()
    assert (tb.vae_scale_factor, tb.sample_size, tb.in_channels) == \
        (jb.vae_scale_factor, jb.sample_size, jb.in_channels)
    cfg = port_bundle_config(jb.config)
    # the default device is CUDA, and CUDA that is absent raises: no code
    # picks the CPU because it found no GPU
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            load_bundle("toy", TORCH_TOY_RUNTIME, bundle_config=cfg)
    # a checkpoint directory that is not there is named; one that is loads
    with pytest.raises(FileNotFoundError, match="/nowhere"):
        load_bundle("toy", TORCH_TOY_RUNTIME, bundle_config=cfg,
                    device="cpu", checkpoint_dir="/nowhere")
    save_bundle(tb, str(tmp_path))
    loaded = load_bundle("toy", TORCH_TOY_RUNTIME, bundle_config=cfg,
                         device="cpu", checkpoint_dir=str(tmp_path), seed=1)
    for a, b in ((tb.unet, loaded.unet), (tb.vae_fp32, loaded.vae_fp32),
                 (tb.text_models[0], loaded.text_models[0])):
        for (k, x), y in zip(a.state_dict().items(), b.state_dict().values()):
            assert torch.equal(x, y), k
    # a ControlNet bundle: the other models' weights do not depend on it
    plain = load_bundle("toy", TORCH_TOY_RUNTIME, bundle_config=cfg,
                        device="cpu", seed=1)
    cn = load_bundle("toy", TORCH_TOY_RUNTIME, bundle_config=cfg,
                     device="cpu", seed=1, controlnet_model="canny")
    assert plain.controlnet is None and cn.controlnet is not None
    for a, b in zip(plain.unet.parameters(), cn.unet.parameters()):
        assert torch.equal(a, b)
    # SDXL builds like the others: on the default device, which is absent here
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            load_bundle("XL1.0", TORCH_TOY_RUNTIME)


def test_seeded_init_is_deterministic_and_bf16_copy_keeps_fp32_norms():
    jb, _ = toy_bundles()
    cfg = port_bundle_config(jb.config)
    a = load_bundle("toy", TORCH_TOY_RUNTIME, bundle_config=cfg, seed=3, device="cpu")
    b = load_bundle("toy", TORCH_TOY_RUNTIME, bundle_config=cfg, seed=3, device="cpu")
    c = load_bundle("toy", TORCH_TOY_RUNTIME, bundle_config=cfg, seed=4, device="cpu")
    wa, wb, wc = (m.unet.conv_in.weight for m in (a, b, c))
    assert torch.equal(wa, wb) and not torch.equal(wa, wc)
    assert a.vae is a.vae_fp32
    rt = tcfg.RuntimeConfig(param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16)
    h = load_bundle("toy", rt, bundle_config=cfg, seed=3, device="cpu")
    assert h.unet.conv_in.weight.dtype == torch.bfloat16
    assert h.vae.decoder.conv_in.weight.dtype == torch.bfloat16
    assert h.vae.decoder.conv_norm_out.weight.dtype == torch.float32
    assert h.vae_fp32.decoder.conv_in.weight.dtype == torch.float32
    # non-XL decode runs in the compute dtype, the encode always in fp32
    assert h.vae_decode(torch.zeros(1, 4, 4, 4)).dtype == torch.bfloat16
    assert h.vae_encode_sample(torch.zeros(1, 3, 8, 8), torch.zeros(1, 4, 4, 4)).dtype == torch.float32
