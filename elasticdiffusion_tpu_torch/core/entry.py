"""One denoise step on its own, for benchmarks and other callers.

Counterpart of ``elasticdiffusion_tpu/core/entry.py``: the step
``generate_image`` runs, with its inputs at step 0, built without running a
generation. The JAX package's ``segmented`` step is a TPU-runtime
workaround and has no counterpart here.
"""

from __future__ import annotations

import dataclasses

import torch

from ..sched.weight_schedulers import CosineScheduler
from .pipeline import ElasticDiffusion, _fold


def make_denoise_step(pipe: ElasticDiffusion, height: int, width: int,
                      num_inference_steps: int = 50,
                      guidance_scale: float = 10.0, resampling_steps: int = 7,
                      new_p: float = 0.3, repaint: bool = True,
                      prompt: str = "a photo", negative: str = "",
                      controlnet_cond=None, controlnet_scale: float = 1.0):
    """Returns ``(step_fn, (latent, generator, inp), view_plan)`` for step 0
    of one prompt at height x width.

    ``step_fn(latent, generator, inp)`` runs one elastic step, drawing its
    random numbers from `generator`, and returns (next latent, aux). The
    latent, the generator and the step's constants are those
    ``generate_image`` starts from with the pipe's seed and the default RRG
    schedule, so one call equals ``generate_image``'s first step."""
    ctx = pipe._context([prompt], [negative], height, width, guidance_scale,
                        resampling_steps, new_p, controlnet_cond,
                        controlnet_scale)
    do_repaint = repaint and resampling_steps > 0
    sched = pipe._schedule(ctx, num_inference_steps, 0.2, 1000.0,
                           CosineScheduler, 3.0, do_repaint)
    inp, use_repaint = sched.inputs(0)

    @torch.no_grad()
    def step_fn(latent, generator, inp):
        return pipe._denoise_step(dataclasses.replace(ctx, generator=generator),
                                  latent, inp, use_repaint)

    vsf = pipe.vae_scale_factor
    dev = pipe.device
    latent = torch.randn(
        (1, pipe.bundle.in_channels, height // vsf, width // vsf),
        generator=torch.Generator(device=dev).manual_seed(_fold(pipe._seed, 1)),
        device=dev)
    return step_fn, (latent, ctx.generator, inp), ctx.view_plan
