"""text2img CLI of the port.

Counterpart of ``elasticdiffusion_tpu/apps/cli.py``: the same flags, defaults
and types (the reference's flag surface, booleans parsed by ``str2bool``),
the same output directory. ``--checkpoint_dir`` takes the JAX package's
converted directory or a diffusers pipeline directory
(``models/registry.py``'s ``load_bundle``); ``--fp32`` runs fp32 weights and
compute instead of bf16; ``--low_vram`` is the pipeline's ``low_vram``. There
is no compilation cache to enable, and ``--mesh`` other than ``1x1`` raises:
multi-GPU is not ported.

    python -m elasticdiffusion_tpu_torch.apps.cli --sd_version 1.5 \\
        --checkpoint_dir ckpt/sd15 --H 512 --W 768
"""

from __future__ import annotations

import argparse
import os
from datetime import datetime


def str2bool(v):
    if isinstance(v, bool):
        return v
    return str(v).lower() in ("1", "true", "yes", "y", "t")


def build_parser(controlnet: bool = False) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--prompt", type=str,
                   default="A realistic portrait of a young black woman. she "
                           "has a Christmas red hat and a red scarf. Her eyes "
                           "are light brown like they're almost caramel color. "
                           "Her attire, simple yet dignified.")
    p.add_argument("--negative", type=str,
                   default="blurry, ugly, duplicate, no details, deformed")
    p.add_argument("--sd_version", type=str, default="XL1.0",
                   help="['1.4','1.5','2.0','2.1','XL1.0'] or an HF model key")
    p.add_argument("--H", type=int, default=2048)
    p.add_argument("--W", type=int, default=2048)
    p.add_argument("--low_vram", type=str2bool, default=False,
                   help="tiled_decode's tiles overlap by half")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--num_sampled", type=int, default=1)
    p.add_argument("--guidance_scale", type=float, default=10.0)
    p.add_argument("--cosine_scale", type=float, default=10.0,
                   help="effective only with CosineScheduler")
    p.add_argument("--rrg_scale", type=float, default=4000)
    p.add_argument("--resampling_steps", type=int, default=10)
    p.add_argument("--new_p", type=float, default=0.3)
    p.add_argument("--rrg_stop_t", type=float, default=0.2)
    p.add_argument("--view_batch_size", type=int, default=16)
    p.add_argument("--outdir", type=str, default="results_log/")
    p.add_argument("--make_grid", type=str2bool, default=False)
    p.add_argument("--repaint_sampling", type=str2bool, default=True)
    p.add_argument("--tiled_decoder", type=str2bool, default=False)
    p.add_argument("--exp", type=str, default="ElasticDiffusion")
    p.add_argument("--tag", type=str, default="")
    p.add_argument("--log_freq", type=int, default=5)
    p.add_argument("--verbose", type=str2bool, default=False)
    p.add_argument("--checkpoint_dir", type=str, default=None,
                   help="converted .npz directory or diffusers pipeline "
                        "directory")
    p.add_argument("--tokenizer_dir", type=str, default=None, nargs="*",
                   help="dir(s) with vocab.json+merges.txt")
    p.add_argument("--mesh", type=str, default=None,
                   help="only 1x1: multi-GPU is not ported")
    p.add_argument("--fp32", type=str2bool, default=False)
    if controlnet:
        p.add_argument("--controlnet_conditioning_scale", type=float, default=0.2)
        p.add_argument("--condition_image", type=str,
                       default="imgs/input/yoga.jpeg")
        p.add_argument("--controlnet_model", type=str, default="depth",
                       choices=["canny", "depth"])
    return p


def runtime_config(opt):
    """The RuntimeConfig of a parsed command line: bf16 weights and compute,
    fp32 with --fp32; the view batch is the pipe's ``view_batch_size``."""
    import torch
    from ..configs import RuntimeConfig
    dtype = torch.float32 if opt.fp32 else torch.bfloat16
    return RuntimeConfig(param_dtype=dtype, compute_dtype=dtype,
                         view_batch_size=0)


def make_pipe(opt, controlnet_model=None, device="cuda", bundle_config=None):
    """The pipe of a parsed command line, on `device`. `bundle_config`
    replaces the config of ``--sd_version`` (toy models in tests)."""
    from ..core.pipeline import ElasticDiffusion, _later
    from ..models.registry import load_bundle
    if opt.mesh and opt.mesh.lower() != "1x1":
        raise _later("a device mesh", "multi-GPU")
    runtime = runtime_config(opt)
    tok = tuple(opt.tokenizer_dir) if opt.tokenizer_dir else None
    bundle = load_bundle(opt.sd_version, runtime=runtime,
                         checkpoint_dir=opt.checkpoint_dir,
                         controlnet_model=controlnet_model,
                         tokenizer_dirs=tok, bundle_config=bundle_config,
                         device=device)
    return ElasticDiffusion(device=device, sd_version=opt.sd_version,
                            verbose=opt.verbose, log_freq=opt.log_freq,
                            view_batch_size=opt.view_batch_size,
                            low_vram=opt.low_vram,
                            controlnet_model=controlnet_model,
                            runtime=runtime, bundle=bundle)


def request_kwargs(opt) -> dict:
    """The generate_image arguments of a parsed command line."""
    return dict(prompts=[opt.prompt] * opt.num_sampled,
                negative_prompts=opt.negative, height=opt.H, width=opt.W,
                num_inference_steps=opt.steps, grid=opt.make_grid,
                guidance_scale=opt.guidance_scale,
                resampling_steps=opt.resampling_steps, new_p=opt.new_p,
                cosine_scale=opt.cosine_scale, rrg_init_weight=opt.rrg_scale,
                rrg_stop_t=opt.rrg_stop_t,
                repaint_sampling=opt.repaint_sampling,
                tiled_decoder=opt.tiled_decoder)


def save_outputs(opt, imgs, image_log):
    current_time = datetime.now().strftime("%Y-%m-%d %H:%M:%S")
    save_dir = os.path.join(opt.outdir, opt.exp, f"{current_time}_{opt.seed}")
    os.makedirs(save_dir, exist_ok=True)
    for i, img in enumerate(imgs):
        img.save(f"{save_dir}/{i}.png")
    for key, val in image_log.items():
        if isinstance(val, dict):
            for label, img in val.items():
                img.save(f"{save_dir}/{key}_{label}.png")
        elif hasattr(val, "save"):
            val.save(f"{save_dir}/{key}.png")
    with open(f"{save_dir}/args.txt", "w") as f:
        f.write("\n".join(f"{k}: {v}" for k, v in vars(opt).items()))
    return save_dir


def main(argv=None):
    """Run one command line; returns the directory the images went to."""
    opt = build_parser().parse_args(argv)
    from tqdm import tqdm
    from ..utils.timeit import timelog
    timelog.sync = opt.verbose

    pipe = make_pipe(opt)
    pipe.seed_everything(opt.seed)
    imgs, image_log = pipe.generate_image(progress=tqdm, **request_kwargs(opt))
    if opt.verbose:
        timelog.print_results()
    print(f"[metrics] {pipe.last_metrics}")
    save_dir = save_outputs(opt, imgs, image_log)
    print(f"[INFO] saved to {save_dir}")
    return save_dir


if __name__ == "__main__":
    main()
