"""Model bundle: the full SD stack of one version, on one device.

Counterpart of ``elasticdiffusion_tpu/models/registry.py``. A ``ModelBundle``
holds the UNet, the VAE, the text encoders and the tokenizers, and offers the
forwards the pipeline calls: ``apply_unet``, ``vae_decode``,
``vae_encode_sample``, ``encode_text``. ``load_bundle`` builds one with seeded
random weights directly on the device (no checkpoint files are part of the
repository yet). The JAX package's segmented chain, text offload and scan
restacking are TPU-runtime work and have no counterpart.

The device is explicit: ``device="cuda"`` is the default and raises when CUDA
is absent; the CPU is used only when the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import copy
import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn as nn

from ..configs import ModelBundleConfig, RuntimeConfig, get_bundle_config
from ..utils.tokenizer import CLIPTokenizer
from .clip import CLIPTextModel
from .layers import set_use_kernels
from .unet import UNet2DCondition
from .vae import AutoencoderKL


def resolve_device(device) -> torch.device:
    """The device an entry point runs on. No code picks the CPU because it
    found no GPU: the default is CUDA, and CUDA that is absent raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "the port runs on a CUDA device and none is available; pass "
            "device='cpu' explicitly for a CPU run (tests do)")
    return dev


class _fp32_convs:
    """fp32 convolutions in full fp32 (cuDNN would use TF32 by default)
    around the fp32 VAE paths, which are fp32 because they are sensitive to
    precision."""

    def __enter__(self):
        self.prev = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        torch.backends.cudnn.allow_tf32 = self.prev


@dataclass
class ModelBundle:
    config: ModelBundleConfig
    runtime: RuntimeConfig
    device: torch.device
    unet: UNet2DCondition
    vae: AutoencoderKL            # compute-dtype copy (the fp32 one if equal)
    vae_fp32: AutoencoderKL       # fp32 master weights
    text_models: Tuple[CLIPTextModel, ...]
    tokenizers: Tuple[CLIPTokenizer, ...]

    def set_use_kernels(self, mode: str) -> None:
        """Flip every norm and attention module between the kernels and
        their plain versions ('auto' | 'on' | 'off')."""
        for m in (self.unet, self.vae, self.vae_fp32, *self.text_models):
            set_use_kernels(m, mode)

    @torch.no_grad()
    def apply_unet(self, latent_nchw, t, context, added_text_embeds=None,
                   added_time_ids=None):
        return self.unet(latent_nchw, t, context,
                         added_text_embeds=added_text_embeds,
                         added_time_ids=added_time_ids)

    @torch.no_grad()
    def vae_decode(self, latents_nchw):
        """Latents (already divided by scaling_factor) -> RGB in [-1,1].
        fp32 only when the config demands it (force_upcast) and the runtime
        allows it; otherwise the compute dtype."""
        if self.config.vae.force_upcast and self.runtime.vae_decode_fp32:
            with _fp32_convs():
                return self.vae_fp32.decode(latents_nchw.float())
        return self.vae.decode(latents_nchw)

    @torch.no_grad()
    def vae_encode_sample(self, images_nchw, noise):
        """Images in [-1,1] -> sampled latents (the caller applies
        scaling_factor). Always fp32: the VAE encoder is sensitive to
        precision."""
        with _fp32_convs():
            return self.vae_fp32.encode_sample(images_nchw.float(),
                                               noise.float())

    @torch.no_grad()
    def encode_text(self, input_ids, encoder_id: int = 0):
        ids = torch.as_tensor(input_ids, device=self.device)
        return self.text_models[encoder_id](ids)

    @property
    def vae_scale_factor(self) -> int:
        return self.config.vae.scale_factor

    @property
    def sample_size(self) -> int:
        return self.config.unet.sample_size

    @property
    def in_channels(self) -> int:
        return self.config.unet.in_channels


@torch.no_grad()
def seeded_init_(module: nn.Module, generator: torch.Generator) -> None:
    """Random weights from an explicit generator, in place, on the module's
    device: matrices and convolutions N(0, 1/fan_in) (the JAX package's
    lecun-normal), embeddings N(0, 0.02^2), norm weights 1, biases 0."""
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d)):
            fan_in = m.weight[0].numel()
            m.weight.normal_(0.0, 1.0 / math.sqrt(fan_in), generator=generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.Embedding):
            m.weight.normal_(0.0, 0.02, generator=generator)
        elif hasattr(m, "weight") and hasattr(m, "bias") \
                and isinstance(m.weight, nn.Parameter):  # the norms
            m.weight.fill_(1.0)
            m.bias.zero_()


def _build(factory, device: torch.device, generator: torch.Generator):
    """Construct on the meta device, allocate on `device`, init from the
    generator: no default init is ever computed and thrown away."""
    with torch.device("meta"):
        module = factory()
    module = module.to_empty(device=device)
    seeded_init_(module, generator)
    return module.eval().requires_grad_(False)


def _to_compute(vae: AutoencoderKL, dtype: torch.dtype) -> AutoencoderKL:
    """A compute-dtype copy of the fp32 VAE: matrices and convolutions are
    cast, norm parameters stay fp32 (the kernels take either)."""
    if dtype == torch.float32:
        return vae
    twin = copy.deepcopy(vae)
    for m in twin.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d)):
            m.to(dtype)
    return twin


def load_bundle(sd_version: str, runtime: RuntimeConfig = RuntimeConfig(),
                checkpoint_dir: Optional[str] = None,
                controlnet_model: Optional[str] = None,
                tokenizer_dirs: Optional[Tuple[Optional[str], ...]] = None,
                seed: int = 0,
                bundle_config: Optional[ModelBundleConfig] = None,
                device="cuda") -> ModelBundle:
    """Build a ModelBundle with seeded random weights on `device`."""
    if checkpoint_dir is not None:
        raise NotImplementedError(
            "loading converted checkpoints waits until checkpoint files are "
            "part of the repository (ROADMAP.md Queue 1, 'real checkpoints')")
    if controlnet_model is not None:
        raise NotImplementedError(
            "ControlNet is not ported yet (ROADMAP.md Queue 1, ControlNet)")
    cfg = bundle_config or get_bundle_config(sd_version)
    if cfg.is_xl:
        raise NotImplementedError(
            "SDXL (text_time conditioning, two text encoders, fp32 "
            "force_upcast decode) is not wired yet (ROADMAP.md Queue 1, SDXL)")
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    uk = runtime.use_kernels

    unet = _build(lambda: UNet2DCondition(cfg.unet, use_kernels=uk), dev, gen)
    unet = unet.to(dtype=runtime.param_dtype,
                   memory_format=torch.channels_last)
    vae_fp32 = _build(lambda: AutoencoderKL(cfg.vae, use_kernels=uk), dev, gen)
    vae_fp32 = vae_fp32.to(memory_format=torch.channels_last)
    vae = _to_compute(vae_fp32, runtime.compute_dtype)
    text_models = tuple(
        _build(lambda tc=tc: CLIPTextModel(tc, use_kernels=uk), dev, gen)
        .to(dtype=runtime.param_dtype) for tc in cfg.text_encoders)

    if tokenizer_dirs is None:
        tokenizer_dirs = tuple([None] * len(cfg.text_encoders))
    tokenizers = tuple(
        CLIPTokenizer(vocab_dir=td, vocab_size=cfg.text_encoders[i].vocab_size)
        for i, td in enumerate(tokenizer_dirs))

    return ModelBundle(config=cfg, runtime=runtime, device=dev, unet=unet,
                       vae=vae, vae_fp32=vae_fp32, text_models=text_models,
                       tokenizers=tokenizers)
