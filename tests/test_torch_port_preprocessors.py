"""The port's condition preprocessors against the JAX package's: the same
numpy algorithms, so the same bits; and the port's canny against OpenCV's,
the reference's own call. Images come from a numpy seed.

OpenCV is imported when the module is: a worker that collects this file
then holds the real ``cv2``, and the reference loader's stand-in for it
(``tests/reference_import.py``, used where the reference's own imports are
missing) cannot replace it for the tests that run later in that worker."""

import numpy as np
import pytest
import torch
from PIL import Image

try:
    import cv2
except ImportError:  # the test against OpenCV skips
    cv2 = None

import elasticdiffusion_tpu.apps.preprocessors as jpre
import elasticdiffusion_tpu_torch.apps.preprocessors as tpre


def _image(seed, shape, smooth):
    """A random image, or shapes on a background (edges canny keeps)."""
    rng = np.random.default_rng(seed)
    if not smooth:
        return rng.integers(0, 256, shape).astype(np.uint8)
    img = np.full(shape, rng.integers(0, 256), np.uint8)
    for _ in range(6):
        y0, x0 = rng.integers(0, shape[0] - 8), rng.integers(0, shape[1] - 8)
        h, w = rng.integers(4, shape[0] // 2), rng.integers(4, shape[1] // 2)
        img[y0:y0 + h, x0:x0 + w] = rng.integers(0, 256, shape[2:] or None)
    return img


@pytest.mark.parametrize("seed,shape,smooth,dtype", [
    (0, (40, 56, 3), True, np.uint8),
    (1, (40, 56, 3), False, np.uint8),
    (2, (33, 47), True, np.uint8),
    (3, (33, 47, 3), True, np.float32),
], ids=["rgb_shapes", "rgb_noise", "gray", "float"])
def test_canny_is_bit_exact(seed, shape, smooth, dtype):
    img = _image(seed, shape, smooth).astype(dtype)
    want = jpre.canny(img, 100, 200)
    got = tpre.canny(img, 100, 200)
    assert got.dtype == np.uint8 and got.shape == shape[:2]
    np.testing.assert_array_equal(got, want)
    assert 0 < int((got == 255).sum()) < got.size


@pytest.mark.parametrize("channels", [None, 3], ids=["gray", "rgb"])
def test_canny_is_opencv_canny(channels):
    if cv2 is None:
        pytest.skip("OpenCV is not installed")
    rng = np.random.default_rng(6)
    shape = (48, 64) if channels is None else (48, 64, channels)
    for smooth in (True, False):  # blurred noise, then raw noise
        img = (rng.random(shape) * 255).astype(np.uint8)
        if smooth:
            img = cv2.GaussianBlur(img, (5, 5), 1.5)
        for low, high in ((100, 200), (50, 150)):
            np.testing.assert_array_equal(tpre.canny(img, low, high),
                                          cv2.Canny(img, low, high))


@pytest.mark.parametrize("as_pil,batch,cfg", [(True, 1, False),
                                              (False, 2, True)])
def test_prepare_image_equals_jax(as_pil, batch, cfg):
    img = _image(4, (37, 53, 3), True)
    src = Image.fromarray(img) if as_pil else img
    want = jpre.prepare_image(src, 64, 48, batch, cfg)
    got = tpre.prepare_image(src, 64, 48, batch, cfg)
    assert got.shape == (batch * (2 if cfg else 1), 3, 48, 64)
    np.testing.assert_array_equal(got, want)


def test_process_condition_image_equals_jax():
    img = _image(5, (40, 56, 3), True)
    for model, depth_fn in (("canny", None),
                            ("depth", lambda im: np.asarray(im, np.float32)
                             .mean(-1) ** 1.5)):
        want = jpre.process_condition_image(img, model, depth_fn)
        got = tpre.process_condition_image(img, model, depth_fn)
        assert got.mode == "RGB" and got.size == (56, 40)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    with pytest.raises(ValueError, match="unknown"):
        tpre.process_condition_image(img, "pose")


def test_default_depth_fn_needs_weights(monkeypatch, tmp_path):
    """ED_DPT_DIR names a transformers DPT directory: a missing one is named,
    a tiny one loads (on the CPU here); without it or ED_DPT_ALLOW_RANDOM
    the depth function raises."""
    import transformers
    from elasticdiffusion_tpu_torch.models import dpt as tdpt
    monkeypatch.setattr(tpre, "_builtin_depth_fn", None)
    monkeypatch.delenv("ED_DPT_ALLOW_RANDOM", raising=False)
    monkeypatch.setenv("ED_DPT_DIR", "/nowhere")
    with pytest.raises(FileNotFoundError, match="/nowhere"):
        tpre.default_depth_fn()
    transformers.DPTForDepthEstimation(transformers.DPTConfig(
        hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
        intermediate_size=64, image_size=64, patch_size=16,
        backbone_out_indices=[0, 0, 1, 1], neck_hidden_sizes=[16, 24, 32, 32],
        fusion_hidden_size=24)).save_pretrained(str(tmp_path))
    load = tdpt.load_dpt
    monkeypatch.setattr(tdpt, "load_dpt",
                        lambda d, device="cuda": load(d, device="cpu"))
    monkeypatch.setenv("ED_DPT_DIR", str(tmp_path))
    depth = tpre.default_depth_fn()(np.zeros((20, 30, 3), np.uint8))
    assert depth.shape == (20, 30) and np.isfinite(depth).all()
    monkeypatch.setattr(tpre, "_builtin_depth_fn", None)
    monkeypatch.delenv("ED_DPT_DIR")
    with pytest.raises(RuntimeError, match="ED_DPT_ALLOW_RANDOM"):
        tpre.default_depth_fn()
    if not torch.cuda.is_available():
        # random weights are built on the default device, the GPU
        monkeypatch.setenv("ED_DPT_ALLOW_RANDOM", "1")
        with pytest.warns(UserWarning, match="random"), \
                pytest.raises(RuntimeError, match="CUDA"):
            tpre.default_depth_fn()
