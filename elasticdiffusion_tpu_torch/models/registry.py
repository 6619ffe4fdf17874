"""Model bundle: the full SD stack of one version, on one device.

Counterpart of ``elasticdiffusion_tpu/models/registry.py``. A ``ModelBundle``
holds the UNet, the VAE, the text encoders, the tokenizers and, when asked
for, the ControlNet, and offers the forwards the pipeline calls:
``apply_unet``, ``apply_controlnet``, ``vae_decode``, ``vae_encode_sample``,
``encode_text``. ``load_bundle`` builds one directly on the device, with
seeded random weights or the weights of a checkpoint directory (the JAX
package's converted ``.npz`` files or a diffusers pipeline directory, read
by ``models/convert.py``), for every family of ``configs.get_bundle_config``:
SD 1.4 / 1.5, SD 2.0 / 2.1 and SDXL 1.0 (two text encoders, the second
tokenizer padding with id 0, fp32 ``force_upcast`` decode).
``runtime.conv_impl`` goes to the UNet and the ControlNet; the VAE's
convolutions stay on cuDNN, as the JAX package's VAE never asks for its conv
kernel. The JAX package's segmented
chain, text offload and scan restacking are TPU-runtime work and have no
counterpart.

The device is explicit: ``device="cuda"`` is the default and raises when CUDA
is absent; the CPU is used only when the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import contextlib
import copy
import math
import time
import warnings
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import torch
import torch.nn as nn

from ..configs import (ControlNetConfig, ModelBundleConfig, RuntimeConfig,
                       get_bundle_config)
from ..utils import trace
from ..utils.tokenizer import CLIPTokenizer
from .clip import CLIPTextModel
from .convert import checkpoint_layout, load_into, read_model
from .controlnet import ControlNet
from .layers import set_conv_impl, set_use_kernels
from .unet import UNet2DCondition
from .unet_graphs import UNetGraphs, graph_key
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
    around every model forward: the fp32 VAE paths, which are fp32 because
    they are sensitive to precision, and the UNet, ControlNet and decode
    of the ``--fp32`` configuration, held to fp32 by the CPU parity tests.
    The flag touches only fp32 convolutions, so a bf16 forward runs as
    before."""

    def __enter__(self):
        self.prev = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        torch.backends.cudnn.allow_tf32 = self.prev


class CallClock:
    """The device seconds of the calls it is put around, summed from
    ``start()`` to ``read()``; outside that period it times nothing. On a
    CUDA device a call is timed from an event recorded on the current
    stream just before it to one recorded just after it: stream time, so
    the device's waits for the call's launches count. The event pairs come
    from a pool that grows to the most calls one period holds and is reused
    after; nothing synchronises, so ``read()`` after a synchronisation. On
    the CPU, which has run a call when it returns, the host clock."""

    def __init__(self):
        self._pairs: List[tuple] = []
        self._used = 0
        self._host_s = 0.0
        self._on = False

    def start(self) -> None:
        self._used, self._host_s, self._on = 0, 0.0, True

    def begin(self, device: torch.device):
        """A tick for ``end``, or None outside a period."""
        if not self._on:
            return None
        if device.type != "cuda":
            return time.perf_counter()
        if self._used == len(self._pairs):
            self._pairs.append((torch.cuda.Event(enable_timing=True),
                                torch.cuda.Event(enable_timing=True)))
        start, done = self._pairs[self._used]
        self._used += 1
        stream = torch.cuda.current_stream(device)
        start.record(stream)
        return done, stream

    def end(self, tick) -> None:
        if isinstance(tick, float):
            self._host_s += time.perf_counter() - tick
        elif tick is not None:
            done, stream = tick
            done.record(stream)

    def read(self) -> float:
        """The period's seconds; ends the period."""
        self._on = False
        return self._host_s + sum(a.elapsed_time(b) for a, b in
                                  self._pairs[:self._used]) / 1e3


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
    controlnet: Optional[ControlNet] = None
    # UNet rows run by ``apply_unet`` since the bundle was made
    unet_rows: int = 0
    # ControlNet rows run since the bundle was made (``apply_controlnet``,
    # ``apply_unet`` with a condition)
    controlnet_rows: int = 0
    # those calls by how the ControlNet ran: replayed from a CUDA graph,
    # captured into one, or eagerly (``models/unet_graphs.py``)
    controlnet_graph_replays: int = 0
    controlnet_graph_captures: int = 0
    controlnet_graph_eager: int = 0
    # the seconds of the ControlNet's part of those calls in a period the
    # caller sets
    controlnet_clock: CallClock = field(default_factory=CallClock, repr=False,
                                        compare=False)
    # the UNet forward's CUDA graphs (``models/unet_graphs.py``)
    unet_graphs: UNetGraphs = field(default_factory=UNetGraphs, repr=False,
                                    compare=False)

    def _denoisers(self):
        return [m for m in (self.unet, self.controlnet) if m is not None]

    def set_use_kernels(self, mode: str) -> None:
        """Flip every norm and attention module between the kernels and
        their plain versions ('auto' | 'on' | 'off')."""
        for m in (*self._denoisers(), self.vae, self.vae_fp32,
                  *self.text_models):
            set_use_kernels(m, mode)
        self.unet_graphs.drop()

    def set_conv_impl(self, mode: str) -> None:
        """'cudnn' | 'kernel' for the 3x3 convolutions of the UNet and the
        ControlNet (the VAE stays on cuDNN)."""
        for m in self._denoisers():
            set_conv_impl(m, mode)
        self.unet_graphs.drop()

    def apply_unet(self, latent_nchw, t, context, added_text_embeds=None,
                   added_time_ids=None, down_block_residuals=None,
                   mid_block_residual=None, controlnet_cond=None,
                   conditioning_scale=1.0):
        """The UNet forward, without autograd. On a CUDA device it runs
        from a CUDA graph of its input key from the key's second call on
        (``models/unet_graphs.py``); on the CPU, eagerly. With a ControlNet
        condition (B, 3, h * f, w * f) the ControlNet runs first and the
        UNet takes its residuals, the two eagerly or as a pair of graphs
        (``UNetGraphs.pair``); the ControlNet's part is counted, timed and
        traced as ``apply_controlnet`` is."""
        if controlnet_cond is not None:
            if down_block_residuals is not None or mid_block_residual is not None:
                raise ValueError("a call with a ControlNet condition makes its "
                                 "own residuals")
            return self._apply_pair(
                latent_nchw, t, context, controlnet_cond, conditioning_scale,
                added_text_embeds=added_text_embeds,
                added_time_ids=added_time_ids)
        self.unet_rows += latent_nchw.shape[0]
        extras = dict(added_text_embeds=added_text_embeds,
                      added_time_ids=added_time_ids,
                      down_block_residuals=down_block_residuals,
                      mid_block_residual=mid_block_residual)
        with torch.no_grad(), _fp32_convs():
            key = graph_key(latent_nchw, t, context, **extras)
            return self.unet_graphs(key, self.unet, latent_nchw, t, context,
                                    **extras)

    def _apply_pair(self, latent_nchw, t, context, cond, scale, **extras):
        self._need_controlnet()
        key = graph_key(latent_nchw, t, context, controlnet_cond=cond,
                        conditioning_scale=scale, **extras)
        self.unet_rows += latent_nchw.shape[0]
        part = lambda kind: self._controlnet_part(latent_nchw, scale, kind)
        with torch.no_grad(), _fp32_convs():
            return self.unet_graphs.pair(key, self.unet, self.controlnet,
                                         latent_nchw, t, context, cond, scale,
                                         part, **extras)

    def _need_controlnet(self) -> None:
        if self.controlnet is None:
            raise ValueError("the bundle has no ControlNet: load it with "
                             "controlnet_model=...")

    @contextlib.contextmanager
    def _controlnet_part(self, latent_nchw, scale, kind: str):
        """Around the ControlNet's part of a call that ran as `kind`
        (``"replay"``, ``"capture"`` or ``"eager"``): counts its rows and
        its kind, times it on ``controlnet_clock``, and records the
        ``controlnet`` span."""
        self.controlnet_rows += latent_nchw.shape[0]
        if kind == "replay":
            self.controlnet_graph_replays += 1
        elif kind == "capture":
            self.controlnet_graph_captures += 1
        else:
            self.controlnet_graph_eager += 1
        with trace.span("controlnet", rows=latent_nchw.shape[0],
                        h=latent_nchw.shape[2], w=latent_nchw.shape[3],
                        scale=scale, graph=kind):
            tick = self.controlnet_clock.begin(latent_nchw.device)
            yield
            self.controlnet_clock.end(tick)

    @torch.no_grad()
    def apply_controlnet(self, latent_nchw, t, context, condition_nchw,
                         conditioning_scale=1.0, added_text_embeds=None,
                         added_time_ids=None):
        """(down residuals, mid residual) for ``apply_unet``, eagerly.
        Counted, timed and traced as the ControlNet's part of
        ``apply_unet`` is."""
        self._need_controlnet()
        with self._controlnet_part(latent_nchw, conditioning_scale,
                                   "eager"), _fp32_convs():
            return self.controlnet(latent_nchw, t, context, condition_nchw,
                                   conditioning_scale=conditioning_scale,
                                   added_text_embeds=added_text_embeds,
                                   added_time_ids=added_time_ids)

    @property
    def fp32_decode(self) -> bool:
        """Whether decodes run in fp32: only when the config demands it
        (force_upcast) and the runtime allows it."""
        return bool(self.config.vae.force_upcast and self.runtime.vae_decode_fp32)

    @torch.no_grad()
    def vae_decode(self, latents_nchw):
        """Latents (already divided by scaling_factor) -> RGB in [-1,1],
        in fp32 where ``fp32_decode`` says so, else in the compute dtype."""
        with _fp32_convs():
            if self.fp32_decode:
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
    lecun-normal), embeddings N(0, 0.02^2), norm weights 1, biases 0.

    Flax initialises the ControlNet's 1x1 zero convolutions and its
    conditioning embedding's ``conv_out`` to zeros; here they are
    lecun-normal like every other convolution. At random weights that is
    what makes the ControlNet's residuals non-zero, so that a run can see
    whether the ControlNet is wired in."""
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d, nn.ConvTranspose2d)):
            # weights are (O, I, ...); a transposed conv's (I, O, kh, kw)
            fan_in = (m.weight[:, 0] if isinstance(m, nn.ConvTranspose2d)
                      else m.weight[0]).numel()
            m.weight.normal_(0.0, 1.0 / math.sqrt(fan_in), generator=generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.Embedding):
            m.weight.normal_(0.0, 0.02, generator=generator)
        elif hasattr(m, "weight") and hasattr(m, "bias") \
                and isinstance(m.weight, nn.Parameter):  # the norms
            m.weight.fill_(1.0)
            m.bias.zero_()


def build_seeded(factory, device: torch.device, generator: torch.Generator):
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
    """Build a ModelBundle on `device`, with seeded random weights or, with
    `checkpoint_dir`, the weights of that directory.

    `controlnet_model` ('canny' | 'depth') adds a ControlNet at the UNet's
    widths (the two conditions share one architecture). It is built after
    every other model, so the other models' weights do not depend on it.

    `checkpoint_dir` is the JAX package's converted directory (``unet.npz``,
    ``vae.npz``, ``text_encoder_{0,1}.npz``, ``controlnet.npz``) or a
    diffusers pipeline directory (``unet/``, ``vae/``, ``text_encoder/``,
    ``text_encoder_2/``, ``controlnet/``). Each model is loaded strictly
    (``convert.load_into``) and cast as the JAX package casts it: the UNet,
    the text encoders and the ControlNet to ``runtime.param_dtype``, the VAE
    to its fp32 master, from which the compute copy is made. A model whose
    file is absent keeps its seeded init, with a warning."""
    cfg = bundle_config or get_bundle_config(sd_version)
    dev = resolve_device(device)
    if checkpoint_dir is not None:
        checkpoint_layout(checkpoint_dir)  # a wrong path fails before any work
    gen = torch.Generator(device=dev).manual_seed(seed)
    uk = runtime.use_kernels

    def load(name: str, module: nn.Module) -> None:
        if checkpoint_dir is None:
            return
        sd = read_model(checkpoint_dir, name, dev)
        if sd is None:
            warnings.warn(f"{checkpoint_dir} has no weights for {name}: it "
                          f"keeps its seeded random init")
        else:
            load_into(module, sd, f"{name} in {checkpoint_dir}")

    unet = build_seeded(lambda: UNet2DCondition(cfg.unet, use_kernels=uk),
                        dev, gen)
    unet = unet.to(dtype=runtime.param_dtype,
                   memory_format=torch.channels_last)
    load("unet", unet)
    set_conv_impl(unet, runtime.conv_impl)
    vae_fp32 = build_seeded(lambda: AutoencoderKL(cfg.vae, use_kernels=uk),
                            dev, gen)
    vae_fp32 = vae_fp32.to(memory_format=torch.channels_last)
    load("vae", vae_fp32)
    vae = _to_compute(vae_fp32, runtime.compute_dtype)
    text_models = []
    for i, tc in enumerate(cfg.text_encoders):
        model = build_seeded(lambda tc=tc: CLIPTextModel(tc, use_kernels=uk),
                             dev, gen).to(dtype=runtime.param_dtype)
        load(f"text_encoder_{i}", model)
        text_models.append(model)
    controlnet = None
    if controlnet_model is not None:
        cn_cfg = ControlNetConfig(unet=cfg.unet,
                                  cond_downsample_factor=cfg.vae.scale_factor)
        controlnet = build_seeded(
            lambda: ControlNet(cn_cfg, use_kernels=uk), dev, gen)
        controlnet = controlnet.to(dtype=runtime.param_dtype,
                                   memory_format=torch.channels_last)
        load("controlnet", controlnet)
        set_conv_impl(controlnet, runtime.conv_impl)

    if tokenizer_dirs is None:
        tokenizer_dirs = tuple([None] * len(cfg.text_encoders))
    # SDXL's second tokenizer pads with id 0, every other one with EOS
    tokenizers = tuple(
        CLIPTokenizer(vocab_dir=td,
                      pad_token_id=0 if (cfg.is_xl and i == 1) else None,
                      vocab_size=cfg.text_encoders[i].vocab_size)
        for i, td in enumerate(tokenizer_dirs))

    return ModelBundle(config=cfg, runtime=runtime, device=dev, unet=unet,
                       vae=vae, vae_fp32=vae_fp32,
                       text_models=tuple(text_models),
                       tokenizers=tokenizers, controlnet=controlnet)
