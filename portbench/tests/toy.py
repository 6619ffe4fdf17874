"""Toy configurations of the two families (SDXL-like with two text
encoders, text_time conditioning and background pads; SD 2-like with one),
the SDXL-like one with a ControlNet, and the SD 2-like one served in
float32 throughout (the CLI's --fp32), at widths a CPU test can run, and a
cell built from each."""

from __future__ import annotations

import copy

from portbench.cells import Cell

CLIP = {"architectures": ["CLIPTextModel"], "vocab_size": 49408,
        "hidden_size": 32, "intermediate_size": 64, "num_hidden_layers": 2,
        "num_attention_heads": 2, "max_position_embeddings": 77,
        "hidden_act": "gelu", "layer_norm_eps": 1e-05, "projection_dim": 32}
VAE = {"in_channels": 3, "out_channels": 3, "latent_channels": 4,
       "block_out_channels": [32, 32], "layers_per_block": 1,
       "norm_num_groups": 32, "sample_size": 32, "scaling_factor": 0.18215}
UNET = {"sample_size": 16, "in_channels": 4, "out_channels": 4,
        "block_out_channels": [32, 64],
        "down_block_types": ["DownBlock2D", "CrossAttnDownBlock2D"],
        "layers_per_block": 1, "transformer_layers_per_block": [1, 2],
        "attention_head_dim": [2, 4], "cross_attention_dim": 32,
        "use_linear_projection": True, "norm_num_groups": 32,
        "flip_sin_to_cos": True, "freq_shift": 0}
BASE = {"native_resolution": 32, "min_latent_size": 16,
        "num_inference_steps": 3,
        "dtypes": {"unet": "bfloat16", "text_encoder": "bfloat16",
                   "vae": "float32", "vae_decode": "bfloat16",
                   "vae_encode": "float32"}}


def sd2_config() -> dict:
    return copy.deepcopy({**BASE, "name": "toy_sd2", "sd_version": "2.1",
                          "is_xl": False, "unet": UNET, "vae": VAE,
                          "text_encoder": {**CLIP, "hidden_act": "quick_gelu"}})


def xl_config() -> dict:
    cfg = copy.deepcopy({**BASE, "name": "toy_xl", "sd_version": "XL1.0",
                         "is_xl": True, "vae": {**VAE, "force_upcast": True},
                         "text_encoder": {**CLIP, "hidden_act": "quick_gelu"},
                         "text_encoder_2": {
                             **CLIP, "architectures": ["CLIPTextModelWithProjection"]}})
    cfg["dtypes"]["vae_decode"] = "float32"
    cfg["unet"] = {**UNET, "cross_attention_dim": 64,
                   "addition_embed_type": "text_time",
                   "addition_time_embed_dim": 8,
                   "projection_class_embeddings_input_dim": 32 + 6 * 8}
    return cfg


def traffic(height: int, width: int, tiled: bool = False) -> dict:
    return {"height": height, "width": width, "guidance_scale": 10.0,
            "resampling_steps": 2, "new_p": 0.3, "rrg_init_weight": 1000.0,
            "rrg_stop_t": 0.4, "cosine_scale": 10.0, "view_batch_size": 16,
            "tiled_decoder": tiled, "repaint_sampling": True,
            "negative_prompt": "blurry, ugly, duplicate, low quality",
            "prompt_words": [3, 8], "words": "words.txt"}


def canny_config() -> dict:
    """xl_config with a ControlNet at the UNet's widths, as the port builds
    it: the conditioning embedding's widths are the two of the port's four
    that the toy VAE's scale factor of 2 takes."""
    cfg = xl_config()
    cfg["name"] = "toy_xl_canny"
    cfg["dtypes"]["controlnet"] = "bfloat16"
    cfg["controlnet"] = {**cfg["unet"], "_class_name": "ControlNetModel",
                         "kind": "canny", "conditioning_channels": 3,
                         "conditioning_embedding_out_channels": [96, 256],
                         "controlnet_conditioning_channel_order": "rgb",
                         "global_pool_conditions": False}
    return cfg


def fp32_config() -> dict:
    cfg = sd2_config()
    cfg["name"] = "toy_sd2_fp32"
    cfg["dtypes"] = {k: "float32" for k in cfg["dtypes"]}
    return cfg


# the published diffusers/controlnet-canny-sdxl-1.0 config.json beyond the
# UNet's keys, for tests at SDXL's widths
CANNY_SDXL = {"_class_name": "ControlNetModel", "kind": "canny",
              "conditioning_channels": 3,
              "conditioning_embedding_out_channels": [16, 32, 96, 256],
              "controlnet_conditioning_channel_order": "rgb",
              "global_pool_conditions": False}
LIMITS = {"first_step": 6.0, "later_step": 6.0, "decode": 0.02}
# the float32 toy's steps are in units of TF32 rounding's effect, which
# its control (TF32 itself) reads as 1; its decode is float32
FP32_LIMITS = {"first_step": 0.25, "later_step": 0.25, "decode": 1e-4}
CONDITION = {"condition": {"kind": "edges", "shapes": [3, 6], "line_px": 2},
             "controlnet_conditioning_scale": 0.5}


def cell(kind: str = "sd2", limits=None) -> Cell:
    """sd2: 64 x 64 pixels (16 views, no pads); xl: 32 x 64 (4 views, the
    global call padded with backgrounds), tiled decoder; canny: xl with a
    ControlNet and an edge map; fp32: sd2 in float32."""
    if kind == "sd2":
        return Cell("toy-sd2", sd2_config(), traffic(64, 64), 1, limits or LIMITS)
    if kind == "fp32":
        return Cell("toy-fp32", fp32_config(), traffic(64, 64), 1, limits or FP32_LIMITS)
    if kind == "canny":
        return Cell("toy-canny", canny_config(), {**traffic(32, 64, tiled=True), **CONDITION},
                    1, limits or LIMITS)
    return Cell("toy-xl", xl_config(), traffic(32, 64, tiled=True), 1, limits or LIMITS)
