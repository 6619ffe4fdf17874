"""The port's DPT depth model and its depth_fn against the JAX package.

A toy DPT (2 layers, 32 wide) with every JAX parameter moved by
0.1 N(0, 1) from a numpy seed, carried into the port by ``dpt_from_jax``;
inputs from a seed; fp32 on the CPU. The module names are those of
``transformers.DPTForDepthEstimation``: a transformers model loads into the
port by name and gives the same depth.

Bars, relative to the largest output magnitude: 1e-4 for the model (fp32
sums in another order through 2 ViT layers and the neck; measured 2e-6),
1e-4 for ``make_depth_fn`` (its two 'linear' resizes: the port multiplies
with the same weight matrices as ``jax.image.resize``, in another order;
measured about 2e-6) and 2e-5 for one resize.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elasticdiffusion_tpu.models.dpt import (DPTDepthConfig as JConfig,
                                             DPTDepthModel as JModel,
                                             make_depth_fn as j_make_depth_fn)
from elasticdiffusion_tpu_torch.models.convert import dpt_from_jax
from elasticdiffusion_tpu_torch.models.dpt import (DPTDepthConfig,
                                                   DPTDepthModel, make_depth_fn,
                                                   random_dpt)
from elasticdiffusion_tpu_torch.ops.resize import linear_resize
from torch_port_common import perturb_tree

TOY = dict(hidden_size=32, num_layers=2, num_heads=2, intermediate_size=64,
           patch_size=16, image_size=64, backbone_out_indices=(0, 0, 1, 1),
           neck_hidden_sizes=(16, 24, 32, 32), fusion_hidden_size=24)


@pytest.fixture(scope="module")
def toy_pair():
    jm = JModel(JConfig(**TOY))
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 3, 64, 64)))["params"]
    params = perturb_tree(params, np.random.default_rng(0))
    cfg = DPTDepthConfig(**TOY)
    tm = DPTDepthModel(cfg).eval()
    tm.load_state_dict(dpt_from_jax(params, cfg.reassemble_factors))
    return jm, jax.tree.map(jnp.asarray, params), tm


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("shape", [(2, 3, 64, 64), (1, 3, 48, 80)],
                         ids=["native", "non_square"])
def test_dpt_matches_jax(toy_pair, shape):
    jm, params, tm = toy_pair
    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    assert np.abs(want).max() > 1.0
    assert _rel(got, want) < 1e-4, _rel(got, want)


def test_make_depth_fn_matches_jax_on_a_non_square_image(toy_pair):
    _, params, tm = toy_pair
    img = np.random.default_rng(2).integers(0, 256, (37, 53, 3)).astype(np.uint8)
    want = j_make_depth_fn(params, JConfig(**TOY), proc_size=64)(img)
    got = make_depth_fn(tm, proc_size=64)(img)
    assert got.shape == want.shape == (37, 53) and got.dtype == np.float32
    assert _rel(got, want) < 1e-4, _rel(got, want)


@pytest.mark.parametrize("shape,size", [((2, 3, 37, 53), (64, 64)),
                                        ((1, 1, 64, 64), (37, 53)),
                                        ((5, 24, 24), (30, 17))],
                         ids=["up", "down", "mixed"])
def test_linear_resize_is_jax_image_resize(shape, size):
    """'linear' antialiases when it shrinks and renormalises at the borders;
    the port computes the same weight matrices."""
    x = np.random.default_rng(3).standard_normal(shape).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), shape[:-2] + size,
                                       method="linear"))
    got = linear_resize(torch.from_numpy(x), size).numpy()
    assert _rel(got, want) < 2e-5, _rel(got, want)


def test_names_are_the_transformers_checkpoint_keys():
    transformers = pytest.importorskip("transformers")
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
    tm = DPTDepthModel(DPTDepthConfig(**{**TOY, "num_layers": 4,
                                         "backbone_out_indices": (0, 1, 2, 3)}))
    res = tm.eval().load_state_dict(hf.state_dict(), strict=False)
    # the final layernorm and the first fusion layer's residual_layer1 never
    # run in the depth model
    assert res.missing_keys == []
    assert sorted(res.unexpected_keys) == sorted(
        ["dpt.layernorm.weight", "dpt.layernorm.bias"]
        + [f"neck.fusion_stage.layers.0.residual_layer1.convolution{i}.{p}"
           for i in (1, 2) for p in ("weight", "bias")])
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (1, 3, 64, 64)).astype(np.float32))
    with torch.no_grad():
        want = hf(x).predicted_depth.numpy()
        got = tm(x).numpy()
    assert _rel(got, want) < 1e-4, _rel(got, want)


def test_random_dpt_is_seeded():
    cfg = DPTDepthConfig(**TOY)
    a, b = (random_dpt(cfg, torch.Generator().manual_seed(3), device="cpu")
            for _ in range(2))
    for (name, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q), name
    assert not a.dpt.embeddings.position_embeddings.any()
    resize = a.neck.reassemble_stage.layers[0].resize
    assert isinstance(resize, torch.nn.ConvTranspose2d)
    assert 0.5 < float(resize.weight.std() * (16 * 4 * 4) ** 0.5) < 2.0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            random_dpt(cfg)  # the default device is the GPU
