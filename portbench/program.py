"""The system under test, as a user runs it: ``ElasticDiffusion`` of the
port, built through its own loader and checkpoint converter from the
benchmark's weights, and its ``generate_image`` called as the Gradio demo
calls it. This is the only module of the benchmark that imports the port."""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import torch

from elasticdiffusion_tpu_torch.configs import (CLIPTextConfig,
                                                ControlNetConfig,
                                                ModelBundleConfig,
                                                RuntimeConfig, UNetConfig,
                                                VAEConfig, resolve_model_key)
from elasticdiffusion_tpu_torch.core.pipeline import ElasticDiffusion
from elasticdiffusion_tpu_torch.models.convert import hf_to_port, load_into
from elasticdiffusion_tpu_torch.models.registry import load_bundle

from .reference.elastic import text_encoders
from .reference.models import has_projection
from .weights import DTYPES

# the keys of a ControlNet's config that the port takes from the UNet's
# (``load_bundle`` builds its ControlNet at the UNet's widths), with the
# default of each where a config leaves it out
SHARED_WITH_UNET = {"in_channels": None, "block_out_channels": None,
                    "down_block_types": None, "layers_per_block": None,
                    "transformer_layers_per_block": 1,
                    "attention_head_dim": None, "cross_attention_dim": None,
                    "use_linear_projection": False, "norm_num_groups": 32,
                    "addition_embed_type": None,
                    "addition_time_embed_dim": None,
                    "projection_class_embeddings_input_dim": None,
                    "flip_sin_to_cos": True, "freq_shift": 0}
# what the port's ControlNet does, under the config keys that would change
# it, with their diffusers defaults
CONTROLNET_FIXED = {"conditioning_channels": 3,
                    "controlnet_conditioning_channel_order": "rgb",
                    "global_pool_conditions": False, "class_embed_type": None,
                    "num_class_embeds": None, "encoder_hid_dim": None,
                    "only_cross_attention": False,
                    "resnet_time_scale_shift": "default",
                    "mid_block_scale_factor": 1}


def _tuple(v, n: int) -> tuple:
    return tuple(v) if isinstance(v, (list, tuple)) else (v,) * n


def bundle_config(cfg: dict) -> ModelBundleConfig:
    """The port's configuration of the models of a configuration file."""
    u, v = cfg["unet"], cfg["vae"]
    n = len(u["block_out_channels"])
    unet = UNetConfig(
        sample_size=u["sample_size"], in_channels=u["in_channels"],
        out_channels=u["out_channels"],
        block_out_channels=tuple(u["block_out_channels"]),
        down_block_has_attn=tuple(t.startswith("CrossAttn")
                                  for t in u["down_block_types"]),
        layers_per_block=u["layers_per_block"],
        transformer_layers_per_block=_tuple(
            u.get("transformer_layers_per_block", 1), n),
        cross_attention_dim=u["cross_attention_dim"],
        attention_head_dim=_tuple(u["attention_head_dim"], n),
        use_linear_projection=u.get("use_linear_projection", False),
        norm_num_groups=u.get("norm_num_groups", 32),
        addition_embed_type=u.get("addition_embed_type"),
        addition_time_embed_dim=u.get("addition_time_embed_dim", 256),
        projection_class_embeddings_input_dim=u.get(
            "projection_class_embeddings_input_dim"),
        flip_sin_to_cos=u.get("flip_sin_to_cos", True),
        freq_shift=u.get("freq_shift", 0))
    vae = VAEConfig(
        in_channels=v.get("in_channels", 3), out_channels=v.get("out_channels", 3),
        latent_channels=v["latent_channels"],
        block_out_channels=tuple(v["block_out_channels"]),
        layers_per_block=v["layers_per_block"],
        norm_num_groups=v.get("norm_num_groups", 32),
        scaling_factor=v["scaling_factor"],
        force_upcast=v.get("force_upcast", False),
        sample_size=v.get("sample_size", 512))
    texts = tuple(CLIPTextConfig(
        vocab_size=c["vocab_size"], hidden_size=c["hidden_size"],
        num_layers=c["num_hidden_layers"], num_heads=c["num_attention_heads"],
        intermediate_size=c["intermediate_size"],
        max_position_embeddings=c["max_position_embeddings"],
        hidden_act=c["hidden_act"],
        projection_dim=c["projection_dim"] if has_projection(c) else None,
        layer_norm_eps=c.get("layer_norm_eps", 1e-5),
        eos_token_id=c["vocab_size"] - 1)
        for _, c in text_encoders(cfg))
    return ModelBundleConfig(
        sd_version=cfg["sd_version"], model_key=resolve_model_key(cfg["sd_version"]),
        unet=unet, vae=vae, text_encoders=texts, is_xl=cfg["is_xl"],
        native_resolution=cfg["native_resolution"],
        min_latent_size=cfg["min_latent_size"])


def runtime_config(cfg: dict) -> RuntimeConfig:
    """The port's ``RuntimeConfig`` of a configuration file: ``dtypes.unet``
    sets the weights' and the compute dtype, as the CLI's ``--fp32`` sets
    them (bfloat16 by default); an optional ``runtime`` block may set
    ``conv_impl``. Raises where the file states a dtype that this runtime
    does not serve: the text encoders and a ControlNet take the UNet's; the
    decode is float32 where the VAE forces an upcast or the compute is
    float32, else the compute dtype."""
    dt = cfg["dtypes"]
    extra = dict(cfg.get("runtime", {}))
    if set(extra) - {"conv_impl"}:
        raise ValueError(f"runtime may set conv_impl only, got {sorted(extra)}")
    decode = "float32" if cfg["vae"].get("force_upcast") else dt["unet"]
    served = {"text_encoder": dt["unet"], "vae_decode": decode,
              "vae": "float32", "vae_encode": "float32"}
    if "controlnet" in cfg:
        served["controlnet"] = dt["unet"]
    wrong = {k: v for k, v in served.items() if dt.get(k) != v}
    if wrong:
        stated = {k: dt.get(k) for k in wrong}
        raise ValueError(f"at dtypes.unet {dt['unet']!r} the port serves {wrong}; "
                         f"the file states {stated}")
    dtype = DTYPES[dt["unet"]]
    return RuntimeConfig(param_dtype=dtype, compute_dtype=dtype, **extra)


def check_controlnet(cfg: dict) -> None:
    """Raises where a configuration's ``controlnet`` block is not the
    ControlNet that ``load_bundle`` builds: the UNet's widths, RGB
    conditions, no global pooling, and the conditioning embedding's widths
    that the VAE's scale factor selects from ``ControlNetConfig``'s."""
    cn, u = cfg["controlnet"], cfg["unet"]
    if cn.get("kind") not in ("canny", "depth"):
        raise ValueError(f"controlnet kind must be 'canny' or 'depth', got {cn.get('kind')!r}")
    wrong = [k for k, d in SHARED_WITH_UNET.items() if cn.get(k, d) != u.get(k, d)]
    wrong += [k for k, v in CONTROLNET_FIXED.items() if cn.get(k, v) != v]
    vsf = 2 ** (len(cfg["vae"]["block_out_channels"]) - 1)
    levels = vsf.bit_length()  # log2(vsf) stride-2 convolutions, one more width
    if tuple(cn["conditioning_embedding_out_channels"]) != \
            ControlNetConfig().conditioning_embedding_out_channels[-levels:]:
        wrong.append("conditioning_embedding_out_channels")
    if wrong:
        raise ValueError(f"the port builds its ControlNet from the UNet's config; "
                         f"this controlnet block differs in {wrong}")


@torch.no_grad()
def build_pipe(cfg: dict, weights: Dict[str, dict], device,
               runtime: Optional[RuntimeConfig] = None) -> ElasticDiffusion:
    """``load_bundle`` with the configuration's ``runtime_config`` (or
    `runtime`), and with its ControlNet where it has a ``controlnet`` block,
    each model then loaded strictly from the benchmark's weights through the
    port's converter (``hf_to_port``, ``load_into``), as a checkpoint
    directory would be, and handed to ``ElasticDiffusion(bundle=...)``."""
    kind = None
    if "controlnet" in cfg:
        check_controlnet(cfg)
        kind = cfg["controlnet"]["kind"]
    bundle = load_bundle(cfg["sd_version"], runtime=runtime or runtime_config(cfg),
                         bundle_config=bundle_config(cfg), controlnet_model=kind,
                         device=device)
    load_into(bundle.unet, hf_to_port(weights["unet"], "unet"), "unet")
    if kind is not None:
        load_into(bundle.controlnet, hf_to_port(weights["controlnet"], "controlnet"),
                  "controlnet")
    vae = hf_to_port(weights["vae"], "vae")
    for model in {id(m): m for m in (bundle.vae_fp32, bundle.vae)}.values():
        load_into(model, vae, "vae")
    for model, (name, _) in zip(bundle.text_models, text_encoders(cfg)):
        load_into(model, hf_to_port(weights[name], "clip"), name)
    return ElasticDiffusion(bundle=bundle, device=device)


class StepClock:
    """The ``progress=`` hook of ``generate_image``: marks the start of each
    step and the end of the last. On the GPU the marks are CUDA events
    recorded on the stream as the loop reaches them, so the hook adds no
    synchronisation; read ``durations()`` after the call has synchronised."""

    def __init__(self, cuda: bool):
        self.cuda = cuda
        self.marks: List = []

    def _mark(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())

    def __call__(self, steps):
        for i in steps:
            self._mark()
            yield i
        self._mark()

    def durations(self) -> List[float]:
        """Seconds of each step, from its mark to the next."""
        if not self.cuda:
            return [b - a for a, b in zip(self.marks, self.marks[1:])]
        return [a.elapsed_time(b) / 1e3 for a, b in zip(self.marks, self.marks[1:])]


def request_kwargs(traffic: dict, steps: int) -> dict:
    """``generate_image``'s arguments for a traffic mix, as the demo's
    ``generate_image_fn`` passes them."""
    return dict(height=int(traffic["height"]), width=int(traffic["width"]),
                num_inference_steps=int(steps),
                guidance_scale=float(traffic["guidance_scale"]),
                resampling_steps=int(traffic["resampling_steps"]),
                new_p=float(traffic["new_p"]),
                rrg_init_weight=float(traffic["rrg_init_weight"]),
                rrg_stop_t=float(traffic["rrg_stop_t"]),
                cosine_scale=float(traffic["cosine_scale"]),
                repaint_sampling=bool(traffic.get("repaint_sampling", True)),
                tiled_decoder=bool(traffic["tiled_decoder"]))


def generate(pipe: ElasticDiffusion, traffic: dict, steps: int, req: dict,
             clock: Optional[StepClock] = None,
             condition: Optional[torch.Tensor] = None) -> dict:
    """One image, with the ControlNet `condition` (``traffic.condition_image``)
    where the mix has one. Returns its float image (1, 3, H, W) in [0, 1],
    every step's output latent (T, 1, C, h, w), and the program's
    ``last_metrics``, all on the host."""
    pipe.seed_everything(req["seed"])
    pipe.view_batch_size = int(traffic["view_batch_size"])
    kwargs = request_kwargs(traffic, steps)
    if condition is not None:
        kwargs.update(condition_image=condition, controlnet_conditioning_scale=float(
            traffic["controlnet_conditioning_scale"]))
    image, _ = pipe.generate_image(prompts=req["prompt"],
                                   negative_prompts=req["negative"],
                                   progress=clock, return_arrays=True, **kwargs)
    return {"image": image,
            "latents": torch.stack(pipe.last_step_latents).cpu().numpy(),
            "metrics": dict(pipe.last_metrics)}

