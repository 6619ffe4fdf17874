"""Configuration dataclasses of the port.

Model configs, ``get_bundle_config``, ``DDIMConfig``, ``ViewConfig`` and
``GenerationConfig`` carry the values of ``elasticdiffusion_tpu/configs.py``
unchanged (dtypes are ``torch.dtype``). ``RuntimeConfig`` is cut to what
means something on a GPU; the TPU-runtime knobs are not carried over.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

SDVersion = str  # '1.4' | '1.5' | '2.0' | '2.1' | 'XL1.0' | custom HF key

# Model-key registry.
MODEL_KEYS = {
    "2.1": "stabilityai/stable-diffusion-2-1-base",
    "2.0": "stabilityai/stable-diffusion-2-base",
    "1.5": "runwayml/stable-diffusion-v1-5",
    "1.4": "CompVis/stable-diffusion-v1-4",
    "XL1.0": "stabilityai/stable-diffusion-xl-base-1.0",
}

# ControlNet model keys.
CONTROLNET_KEYS = {
    ("XL1.0", "depth"): "diffusers/controlnet-depth-sdxl-1.0",
    ("XL1.0", "canny"): "diffusers/controlnet-canny-sdxl-1.0",
    ("sd", "depth"): "lllyasviel/sd-controlnet-depth",
    ("sd", "canny"): "lllyasviel/sd-controlnet-canny",
}


def resolve_model_key(sd_version: SDVersion) -> str:
    """Version string -> HF model key; passthrough for custom keys."""
    return MODEL_KEYS.get(sd_version, sd_version)


# ---------------------------------------------------------------------------
# Model architecture configs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class CLIPTextConfig:
    """CLIP text-encoder architecture (transformers CLIPTextModel contract)."""

    vocab_size: int = 49408
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 77
    hidden_act: str = "quick_gelu"  # 'quick_gelu' (SD1.x) | 'gelu' (SD2.x / XL)
    projection_dim: Optional[int] = None  # set for CLIPTextModelWithProjection
    layer_norm_eps: float = 1e-5
    # index of the EOS token used for pooling (argmax over input_ids in HF)
    eos_token_id: int = 49407


CLIP_VIT_L_14 = CLIPTextConfig()  # SD1.x text encoder / SDXL encoder 1
CLIP_VIT_H_14 = CLIPTextConfig(
    hidden_size=1024, num_layers=23, num_heads=16,
    intermediate_size=4096, hidden_act="gelu",
)  # SD2.x text encoder
CLIP_VIT_BIGG_14 = CLIPTextConfig(
    hidden_size=1280, num_layers=32, num_heads=20,
    intermediate_size=5120, hidden_act="gelu", projection_dim=1280,
)  # SDXL text encoder 2 (with projection)


@dataclass(frozen=True)
class VAEConfig:
    """AutoencoderKL architecture + behavioral contract."""

    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 4
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_num_groups: int = 32
    scaling_factor: float = 0.18215
    force_upcast: bool = False  # XL fp16 decoder instability -> fp32 decode
    sample_size: int = 512

    @property
    def scale_factor(self) -> int:
        """Spatial down-factor of the encoder (=8)."""
        return 2 ** (len(self.block_out_channels) - 1)


@dataclass(frozen=True)
class UNetConfig:
    """UNet2DConditionModel architecture covering SD1.x / SD2.x / SDXL."""

    sample_size: int = 64
    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    # per down block: whether it has cross-attention transformers
    down_block_has_attn: Tuple[bool, ...] = (True, True, True, False)
    layers_per_block: int = 2
    # transformer depth per block (index-aligned with block_out_channels)
    transformer_layers_per_block: Tuple[int, ...] = (1, 1, 1, 1)
    cross_attention_dim: int = 768
    # attention head count per block; None = derive from head_dim
    num_attention_heads: Optional[Tuple[int, ...]] = None
    attention_head_dim: Tuple[int, ...] = (8, 8, 8, 8)
    use_linear_projection: bool = False
    norm_num_groups: int = 32
    # SDXL micro-conditioning ('text_time') extras
    addition_embed_type: Optional[str] = None
    addition_time_embed_dim: int = 256
    projection_class_embeddings_input_dim: Optional[int] = None
    pooled_projection_dim: int = 1280  # text_encoder_2 projection_dim
    flip_sin_to_cos: bool = True
    freq_shift: int = 0

    def heads_for_block(self, i: int) -> int:
        """Number of attention heads at block i.

        SD1.x stores head *count* in attention_head_dim (8 heads, dim=ch/8);
        SD2.x / SDXL store per-block head count too (5,10,20 -> head dim 64).
        diffusers quirk: `attention_head_dim` is really num-heads for these
        models; we follow the same convention for converter compatibility.
        """
        if self.num_attention_heads is not None:
            return self.num_attention_heads[i]
        return self.attention_head_dim[i]


UNET_SD1 = UNetConfig()  # SD 1.4 / 1.5
UNET_SD2 = UNetConfig(
    cross_attention_dim=1024,
    attention_head_dim=(5, 10, 20, 20),
    use_linear_projection=True,
)  # SD 2.0-base / 2.1-base
UNET_SDXL = UNetConfig(
    sample_size=128,
    block_out_channels=(320, 640, 1280),
    down_block_has_attn=(False, True, True),
    transformer_layers_per_block=(1, 2, 10),
    cross_attention_dim=2048,
    attention_head_dim=(5, 10, 20),
    use_linear_projection=True,
    addition_embed_type="text_time",
    addition_time_embed_dim=256,
    projection_class_embeddings_input_dim=2816,
)


@dataclass(frozen=True)
class ControlNetConfig:
    """ControlNetModel architecture (UNet down+mid twin with zero-convs and a
    conditioning embedding)."""

    unet: UNetConfig = UNET_SD1
    conditioning_channels: int = 3
    conditioning_embedding_out_channels: Tuple[int, ...] = (16, 32, 96, 256)
    # pixel->latent downsample of the condition embedding (= vae scale
    # factor; 8 for all real SD VAEs, smaller only in toy test configs)
    cond_downsample_factor: int = 8


@dataclass(frozen=True)
class ModelBundleConfig:
    """Everything needed to instantiate one SD family member."""

    sd_version: SDVersion
    model_key: str
    unet: UNetConfig
    vae: VAEConfig
    text_encoders: Tuple[CLIPTextConfig, ...]
    is_xl: bool
    # native training resolution in pixels (drives get_downsample_size)
    native_resolution: int
    # minimum UNet latent input enforced by background padding
    min_latent_size: int


def get_bundle_config(sd_version: SDVersion) -> ModelBundleConfig:
    key = resolve_model_key(sd_version)
    if sd_version in ("1.4", "1.5"):
        return ModelBundleConfig(
            sd_version=sd_version, model_key=key, unet=UNET_SD1,
            vae=VAEConfig(), text_encoders=(CLIP_VIT_L_14,),
            is_xl=False, native_resolution=512, min_latent_size=64,
        )
    if sd_version in ("2.0", "2.1"):
        return ModelBundleConfig(
            sd_version=sd_version, model_key=key, unet=UNET_SD2,
            vae=VAEConfig(), text_encoders=(CLIP_VIT_H_14,),
            is_xl=False, native_resolution=512, min_latent_size=64,
        )
    if sd_version == "XL1.0":
        return ModelBundleConfig(
            sd_version=sd_version, model_key=key, unet=UNET_SDXL,
            vae=VAEConfig(scaling_factor=0.13025, force_upcast=True, sample_size=1024),
            text_encoders=(CLIP_VIT_L_14, CLIP_VIT_BIGG_14),
            is_xl=True, native_resolution=1024, min_latent_size=128,
        )
    # custom HF key: assume SD2-like (the reference would load whatever the
    # key holds; we default to the most common layout and let the converter
    # override via a local config file)
    return ModelBundleConfig(
        sd_version=sd_version, model_key=key, unet=UNET_SD2,
        vae=VAEConfig(), text_encoders=(CLIP_VIT_H_14,),
        is_xl=False, native_resolution=512, min_latent_size=64,
    )


# ---------------------------------------------------------------------------
# Scheduler config
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class DDIMConfig:
    """DDIMScheduler contract pinned by the reference (diffusers 0.21.4
    configs for the 5 supported checkpoints)."""

    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012
    beta_schedule: str = "scaled_linear"
    steps_offset: int = 1
    clip_sample: bool = False
    set_alpha_to_one: bool = False
    prediction_type: str = "epsilon"
    timestep_spacing: str = "leading"


# ---------------------------------------------------------------------------
# Runtime / pipeline configs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ViewConfig:
    """Patch-view geometry:
    window = stride = sample_size//2, context = sample_size - window."""

    window_size: int
    stride: int
    context_size: int

    @staticmethod
    def from_sample_size(sample_size: int, patch_size: Optional[int] = None) -> "ViewConfig":
        ws = patch_size if patch_size is not None else sample_size // 2
        return ViewConfig(window_size=ws, stride=ws, context_size=sample_size - ws)


from .kernels import MODES as USE_KERNELS_MODES  # noqa: E402


@dataclass(frozen=True)
class RuntimeConfig:
    """Execution knobs that mean something on a GPU.

    use_kernels: 'auto' takes the hand-written CUDA kernel for a CUDA tensor
    and the plain version for a CPU tensor; 'on' raises on a CPU tensor;
    'off' takes the plain version everywhere (comparisons only, nothing on
    the main path)."""

    param_dtype: torch.dtype = torch.bfloat16    # device-resident weights
    compute_dtype: torch.dtype = torch.bfloat16  # matmul/conv dtype
    accum_dtype: torch.dtype = torch.float32     # direction/latent accumulators
    vae_decode_fp32: bool = True                 # force_upcast analog
    use_kernels: str = "auto"                    # 'auto' | 'on' | 'off'
    view_batch_size: int = 0                     # 0 = all views in one batch

    def __post_init__(self):
        if self.use_kernels not in USE_KERNELS_MODES:
            raise ValueError(f"use_kernels must be one of {USE_KERNELS_MODES}, "
                             f"got {self.use_kernels!r}")


@dataclass(frozen=True)
class GenerationConfig:
    """`generate_image` kwargs, verbatim API surface."""

    height: int = 768
    width: int = 768
    num_inference_steps: int = 50
    guidance_scale: float = 10.0
    resampling_steps: int = 20
    new_p: float = 0.3
    rrg_stop_t: float = 0.2
    rrg_init_weight: float = 1000.0
    rrg_scheduler: str = "cosine"  # cosine | linear | const
    cosine_scale: float = 3.0
    repaint_sampling: bool = True
    tiled_decoder: bool = False
    grid: bool = False
    patch_size: Optional[int] = None
    seed: int = 0
    # ControlNet extras
    controlnet_conditioning_scale: float = 1.0


def replace(cfg, **kw):
    return dataclasses.replace(cfg, **kw)
