"""Whether what the timed path produced is correct: one image of the window,
drawn from the seed, held to the plain float32 reference.

The reference follows the program's own states. It computes two denoise
steps of that image and the decode:

- ``first_step``: step 0 from the reference's own start (its own text
  encodings, initial latent, schedule and background tables, made from the
  image's seed and prompt as the program makes them), which checks the
  start by itself; step 0 repaints and takes the reduced-resolution
  guidance;
- ``later_step``: one step k of 1 .. T - 1, drawn from the image's seed,
  from the program's latent before it, the generator advanced past the
  steps between. Over the runs every later step is checked: those that
  repaint and guide with the decaying weight (k < 3 at 8 steps), those
  that only repaint, and the last, which does neither;
- ``decode``: the reference's decode of the program's final latent.

A step's number is ||program's output - float32 reference's|| over
||unit reference's - float32 reference's||: the program's error in units of
what the precision just below the reference moves that same step from
that same state. Where the configuration serves its UNet in bfloat16, the
unit reference rounds the inputs of every product to bfloat16 where the
configuration states bfloat16; where it serves its UNet in float32 (the
CLI's ``--fp32``), it runs TF32 products where the configuration states
float32. How far one rounding moves a guided step depends on
the random weights (the guidance amplifies the difference of two nearly
equal predictions by 10, and that difference's share varies from seed to
seed), so the plain ratio ||error|| / ||step|| varied 3.7-fold over seeds
for the program and the control alike; in these units it holds still. The
decode's number is ||program's image - reference's|| / ||reference's||.

The control is the reference in the program's place one precision step
down (``models.Precision``): float8 where the configuration states
bfloat16, TF32 where it states float32. For a float32 UNet the control is
the unit reference itself, and its steps read 1.

With a ControlNet the reference runs it before every UNet forward, on the
request's condition image (``traffic.condition_image``, drawn again from
the image's seed).
"""

from __future__ import annotations

import gc
import math
from typing import Dict

import numpy as np
import torch

from .reference import models as M
from .reference.elastic import Models, Request
from .traffic import condition_image

NUMBERS = ("first_step", "later_step", "decode")
# the models whose precision a configuration's ``dtypes`` states; a
# ControlNet's only where it has one
MODELS = ("unet", "text_encoder", "vae_decode", "vae_encode", "controlnet")


def checked_steps(steps: int, image_seed: int) -> Dict[str, int]:
    """{number: step}: step 0, and a later step drawn from the image's seed."""
    k = 1 + int(np.random.default_rng([int(image_seed) % 2 ** 64, 12]).integers(steps - 1))
    return {"first_step": 0, "later_step": k}


def sample_index(seed: int, n: int) -> int:
    """The image of the window that the check reads, drawn from the seed."""
    return int(np.random.default_rng([int(seed) % 2 ** 64, 11]).integers(n))


def precisions(cfg: dict, mode: str) -> Dict[str, M.Precision]:
    """'fp32' everywhere (the reference); 'unit': bf16 rounding where the
    configuration states bfloat16, and TF32 where it states float32 if its
    UNet is float32; 'control': one step below what it states for each
    model (float8 for bfloat16, TF32 for float32)."""
    dt = cfg["dtypes"]
    unit32 = "tf32" if dt["unet"] == "float32" else "fp32"
    below = {"control": {"bfloat16": "fp8", "float32": "tf32"},
             "unit": {"bfloat16": "bf16", "float32": unit32},
             "fp32": {"bfloat16": "fp32", "float32": "fp32"}}[mode]
    return {k: M.Precision(below[dt[k]]) for k in MODELS if k in dt}


@torch.no_grad()
def reference_outputs(cfg: dict, traffic: dict, steps: int, weights: dict,
                      record: dict, device, mode: str = "fp32",
                      decode: bool = True) -> dict:
    """{number: (step, input, output)} of the checked steps and, with
    `decode`, the decoded image, as the reference computes them in `mode` for the program's
    `record` (its seed, prompts and step latents)."""
    models = Models(cfg, weights, device, precisions(cfg, mode))
    req = Request(models, traffic, steps, record["seed"], record["prompt"],
                  record["negative"], condition_image(traffic, record["seed"], device),
                  traffic.get("controlnet_conditioning_scale", 1.0))
    prog = torch.from_numpy(record["latents"]).to(device)
    lat0 = req.initial_latent()
    wanted = {i: name for name, i in checked_steps(steps, record["seed"]).items()}
    outs = {}
    for i in range(max(wanted) + 1):
        if i in wanted:
            lin = lat0 if i == 0 else prog[i - 1]
            outs[wanted[i]] = (i, lin, req.step(i, lin))
        else:
            req.skip_draws(i, tuple(lat0.shape))
    image = models.decode_image(prog[-1]) if decode else None
    del models, req
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return {"steps": outs, "image": image}


def _norm(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).norm())


def readings(got_latents: Dict[str, torch.Tensor], got_image: torch.Tensor,
             ref: dict, unit: dict) -> Dict[str, float]:
    """The numbers of `got` (the program's, or the control's outputs, by
    number) against the float32 reference `ref`, the steps' in units of the
    unit reference `unit`'s distance from it."""
    out = {}
    for name, (_, _, want) in ref["steps"].items():
        out[name] = _norm(got_latents[name].to(want.device), want) \
            / _norm(unit["steps"][name][2], want)
    img = ref["image"]
    out["decode"] = _norm(got_image.to(img.device), img) / float(img.double().norm())
    return out


def program_readings(record: dict, ref: dict, unit: dict) -> Dict[str, float]:
    dev = ref["image"].device
    lat = torch.from_numpy(record["latents"])
    return readings({name: lat[i] for name, (i, _, _) in ref["steps"].items()},
                    torch.from_numpy(np.asarray(record["image"])).to(dev), ref, unit)


def control_readings(control: dict, ref: dict, unit: dict) -> Dict[str, float]:
    return readings({name: out for name, (_, _, out) in control["steps"].items()},
                    control["image"], ref, unit)


def judge(values: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Correct when every number is finite and within its limit."""
    return all(math.isfinite(values[k]) and values[k] <= limits[k] for k in NUMBERS)
