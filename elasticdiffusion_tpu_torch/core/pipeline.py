"""ElasticDiffusion pipeline: the public API of the port.

Counterpart of ``elasticdiffusion_tpu/core/pipeline.py``. One denoise step
is: the global CFG direction from resampled low-resolution forwards, the
local unconditional score from one batched pass over patch views, a DDIM
update, optionally the repaint re-estimation, and the analytic
reduced-resolution guidance. PyTorch runs eagerly, so the step is a plain
method and the timestep loop a Python loop; per-step constants (DDIM
coefficients, RRG weights, background tables) are computed before the loop.

Runs on the GPU unless the caller passes ``device="cpu"``. Arguments that
belong to a slice not ported yet raise ``NotImplementedError``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..configs import RuntimeConfig, ViewConfig
from ..models.registry import ModelBundle, load_bundle, resolve_device
from ..ops.resample import build_resample_plan, get_downsample_size
from ..ops.views import build_view_plan
from ..sched.ddim import DDIMScheduler
from ..sched.weight_schedulers import (CosineScheduler, make_rrg_scheduler,
                                       rrg_weight_table)
from ..utils.image import make_grid, to_pil
from . import background, signals
from .background import PadSpec


def _later(what: str, item: str):
    return NotImplementedError(f"{what} is not ported yet (ROADMAP.md "
                               f"Queue 1, {item})")


def _fold(seed: int, n: int) -> int:
    """A sub-seed of `seed`, one per purpose."""
    return (int(seed) * 1000003 + n) % (2 ** 63)


@dataclass
class _StepContext:
    """Everything one generate_image call's steps share."""

    resample_plan: Any
    view_plan: Any
    down_pad: PadSpec
    view_pad: PadSpec
    guidance_scale: float
    resampling_steps: int
    drop_p: float
    view_chunk: int
    text_cfg: torch.Tensor
    uncond_text: torch.Tensor
    generator: torch.Generator


class ElasticDiffusion:
    """The reference class's API on PyTorch.

    `view_batch_size` defaults to 0 = "all views in one batched call"; set
    0 < view_batch_size < num_views to chunk the view pass as a memory knob
    (the same numbers either way). The attribute may be changed between
    calls.
    """

    def __init__(self, device="cuda", sd_version: str = "2.0",
                 verbose: bool = False, log_freq: int = 5,
                 view_batch_size: int = 0, low_vram: bool = False,
                 checkpoint_dir: Optional[str] = None,
                 controlnet_model: Optional[str] = None,
                 tokenizer_dirs=None,
                 runtime: Optional[RuntimeConfig] = None,
                 bundle: Optional[ModelBundle] = None,
                 mesh=None):
        if mesh is not None:
            raise _later("a device mesh", "multi-GPU")
        if controlnet_model is not None:
            raise _later("ControlNet", "ControlNet")
        if low_vram:
            raise _later("low_vram (it shapes the tiled decode)",
                         "tiled and halo decode")
        self.sd_version = sd_version
        self.verbose = verbose
        self.log_freq = log_freq
        self.view_batch_size = view_batch_size
        if bundle is None:
            bundle = load_bundle(sd_version, runtime=runtime or RuntimeConfig(),
                                 checkpoint_dir=checkpoint_dir,
                                 tokenizer_dirs=tokenizer_dirs, device=device)
        elif device is not None and \
                resolve_device(device).type != bundle.device.type:
            raise ValueError(f"bundle lives on {bundle.device}, not on "
                             f"{device!r}")
        self.bundle = bundle
        self.device = bundle.device
        # a caller-configured bundle keeps its runtime unless one is given
        self.runtime = runtime if runtime is not None else bundle.runtime
        self.scheduler = DDIMScheduler()
        self.vae_scale_factor = bundle.vae_scale_factor
        self.set_view_config()
        self._seed = 0
        # instrumentation of the last generate_image call
        self.last_metrics: Dict[str, Any] = {}
        self.last_step_latents: list = []

    # ------------------------------------------------------------------
    # API surface
    # ------------------------------------------------------------------

    def set_view_config(self, patch_size: Optional[int] = None):
        self.view_config = ViewConfig.from_sample_size(
            self.bundle.sample_size, patch_size)

    def seed_everything(self, seed: int, seed_np: bool = True):
        """Reset the base seed all downstream generators derive from. No
        global torch seeding: every draw uses an explicit torch.Generator."""
        self._seed = int(seed)
        if seed_np:
            np.random.seed(seed)

    def get_downsample_size(self, H: int, W: int) -> Tuple[int, int]:
        return get_downsample_size(H, W, self.bundle.config.native_resolution,
                                   self.vae_scale_factor)

    def get_text_embeds(self, prompts) -> Tuple[torch.Tensor, torch.Tensor]:
        b = self.bundle
        ids = b.tokenizers[0](prompts)
        last, _, _ = b.encode_text(ids, 0)
        return last.float(), last.float()

    def decode_latents(self, latents) -> torch.Tensor:
        img = self.bundle.vae_decode(
            latents.float() / self.bundle.config.vae.scaling_factor)
        return (img.float() / 2 + 0.5).clamp(0.0, 1.0)

    # ------------------------------------------------------------------
    # vanilla sampling
    # ------------------------------------------------------------------

    @torch.no_grad()
    def generate(self, latent, text_embeds_cfg, add_text_embeds_cfg=None,
                 guidance_scale: float = 7.5, num_inference_steps: int = 50,
                 add_time_ids=None, bg_tables=None, pad_spec=None,
                 state=None):
        """Plain CFG DDIM sampling of a (low-res) latent. Returns
        (image in [0,1], {'inter_x0': [...]})."""
        b = self.bundle
        st = state or self.scheduler.set_timesteps(num_inference_steps)
        latent = torch.as_tensor(latent, device=self.device)
        if pad_spec is None:
            pad_spec = PadSpec(latent.shape[-2], latent.shape[-1],
                               b.config.min_latent_size, b.config.min_latent_size)
        if bg_tables is None and pad_spec.needs_padding:
            bg_tables = background.make_background_table(
                b, st.timesteps, pad_spec, _fold(self._seed, 7), self.scheduler)
        coeff_table = self.scheduler.coeff_tables(st)
        inter_x0 = []
        lat = latent.float()
        for i, t in enumerate(st.timesteps):
            bgs = {s: tbl[i] for s, tbl in (bg_tables or {}).items()}
            direction, eps_u, _ = signals.obtain_latent_direction(
                b, lat, float(t), text_embeds_cfg, pad_spec, bgs,
                add_text_embeds_cfg=add_text_embeds_cfg,
                add_time_ids=add_time_ids)
            pred = eps_u + guidance_scale * direction
            lat, x0 = DDIMScheduler.step_from_coeffs(pred, lat, coeff_table[i])
            if i % self.log_freq == 0:
                inter_x0.append(x0.cpu().numpy())
        return self.decode_latents(lat), {"inter_x0": inter_x0}

    # ------------------------------------------------------------------
    # the main loop
    # ------------------------------------------------------------------

    def _estimate(self, ctx: _StepContext, lat, t, bg_down, bg_view,
                  resampling_steps: int, picks):
        """Global direction + local unconditional score at one latent."""
        res = signals.approximate_latent_direction(
            self.bundle, lat, ctx.generator, t, ctx.text_cfg,
            ctx.resample_plan, ctx.down_pad, bg_down, resampling_steps,
            ctx.drop_p, scripted_picks=picks)
        local = signals.compute_local_uncond_signal(
            self.bundle, lat, t, ctx.uncond_text, ctx.view_plan, ctx.view_pad,
            bg_view, view_batch_size=ctx.view_chunk)
        return res, local

    def _denoise_step(self, ctx: _StepContext, lat, inp: Dict[str, Any],
                      repaint: bool):
        """One elastic denoise step. inp holds the step's constants: t,
        coeffs, rrg_w, bg_down, bg_view, the undo coefficients when
        repainting, and optionally scripted picks and repaint noise."""
        t, coeffs = inp["t"], inp["coeffs"]
        bg_down, bg_view = inp["bg_down"], inp["bg_view"]
        res, local = self._estimate(ctx, lat, t, bg_down, bg_view,
                                    ctx.resampling_steps, inp.get("picks_main"))
        pred = local + ctx.guidance_scale * res.direction
        prev, x0 = DDIMScheduler.step_from_coeffs(pred, lat.float(), coeffs)
        rrg_cfg = ctx.guidance_scale
        used = res

        if repaint:
            lat2 = signals.undo_step(prev, ctx.generator, inp["undo_s1mb"],
                                     inp["undo_sb"],
                                     scripted=inp.get("repaint_noise"))
            res2, local2 = self._estimate(ctx, lat2, t, bg_down, bg_view, 0,
                                          inp.get("picks_repaint"))
            rrg_cfg = ctx.guidance_scale / 3
            pred2 = local2 + rrg_cfg * res2.direction
            prev, x0 = DDIMScheduler.step_from_coeffs(pred2, lat2.float(),
                                                      coeffs)
            used = res2

        cascade, ref_x0 = signals.reduced_resolution_guidance(
            x0, used.downsampled_latent, used.uncond_score,
            used.downsampled_direction, rrg_cfg, inp["rrg_w"], coeffs)
        nxt = prev + cascade if inp["rrg_w"] > 10.0 else prev
        aux = {"x0": x0, "rrg_x0": ref_x0,
               "init_downsampled_latent": res.init_downsampled_latent}
        return nxt, aux

    @torch.no_grad()
    def generate_image(self, prompts, negative_prompts: str = "",
                       height: int = 768, width: int = 768,
                       num_inference_steps: int = 50,
                       guidance_scale: float = 10.0,
                       resampling_steps: int = 20,
                       new_p: float = 0.3, rrg_stop_t: float = 0.2,
                       rrg_init_weight: float = 1000,
                       rrg_scherduler_cls=CosineScheduler,
                       cosine_scale: float = 3.0,
                       repaint_sampling: bool = True,
                       progress=None,
                       tiled_decoder: bool = False,
                       grid: bool = False,
                       latents=None,
                       scripted_noise: Optional[Dict[str, Any]] = None,
                       condition_image=None,
                       controlnet_conditioning_scale: float = 1.0,
                       return_arrays: bool = False,
                       checkpoint_path: Optional[str] = None,
                       checkpoint_every: int = 0,
                       resume_from: Optional[str] = None):
        """The reference signature, including the `rrg_scherduler_cls`
        spelling. Extras: latents / scripted_noise (injected randomness for
        parity), return_arrays. Returns (images, image_log): PIL images, or
        with return_arrays a (B, 3, H, W) float array in [0, 1] and
        {'latent': final latent, ...}."""
        if condition_image is not None:
            raise _later("condition_image (ControlNet)", "ControlNet")
        if tiled_decoder:
            raise _later("tiled_decoder=True", "tiled and halo decode")
        if checkpoint_path is not None or resume_from is not None:
            raise _later("latent checkpoint / resume", "apps and utils")
        t_fn0 = time.time()
        b = self.bundle
        dev = self.device
        on_cuda = dev.type == "cuda"
        if isinstance(prompts, str):
            prompts = [prompts]
        if isinstance(negative_prompts, str):
            negative_prompts = [negative_prompts] * len(prompts)
        B = len(prompts)
        vsf = self.vae_scale_factor
        if height % vsf or width % vsf:
            raise ValueError(f"height {height} and width {width} must be "
                             f"divisible by {vsf}")
        lat_h, lat_w = height // vsf, width // vsf
        down_h, down_w = self.get_downsample_size(height, width)

        # static plans
        resample_plan = build_resample_plan(lat_h, lat_w, down_h, down_w)
        # the effective downsample can differ from the request at awkward ratios
        down_h, down_w = resample_plan.out_h, resample_plan.out_w
        view_plan = build_view_plan(lat_h, lat_w, self.view_config)
        m = b.config.min_latent_size
        down_pad = PadSpec(down_h, down_w, m, m)
        view_pad = PadSpec(*view_plan.out_shape, m, m)
        V = view_plan.num_views
        vbs = self.runtime.view_batch_size or self.view_batch_size
        view_chunk = vbs if vbs and vbs < V else 0

        # schedules
        st = self.scheduler.set_timesteps(num_inference_steps)
        coeff_table = self.scheduler.coeff_tables(st)
        rrg_sched = make_rrg_scheduler(rrg_scherduler_cls, num_inference_steps,
                                       rrg_stop_t, rrg_init_weight, cosine_scale)
        rrg_w = rrg_weight_table(rrg_sched, num_inference_steps)

        # text
        uncond_text, _ = self.get_text_embeds(negative_prompts)
        cond_text, _ = self.get_text_embeds(prompts)
        text_cfg = torch.cat([uncond_text, cond_text])

        # initial latent
        if latents is None:
            gen_init = torch.Generator(device=dev).manual_seed(
                _fold(self._seed, 1))
            lat = torch.randn((B, b.in_channels, lat_h, lat_w),
                              generator=gen_init, device=dev)
        else:
            lat = torch.as_tensor(latents, dtype=torch.float32, device=dev)

        # background tables
        bg_seed = _fold(self._seed, 2)
        bg_down_tbl = background.make_background_table(
            b, st.timesteps, down_pad, bg_seed, self.scheduler) \
            if down_pad.needs_padding else {}
        bg_view_tbl = background.make_background_table(
            b, st.timesteps, view_pad, _fold(bg_seed, 1), self.scheduler) \
            if view_pad.needs_padding else {}

        ctx = _StepContext(
            resample_plan=resample_plan, view_plan=view_plan,
            down_pad=down_pad, view_pad=view_pad,
            guidance_scale=guidance_scale, resampling_steps=resampling_steps,
            drop_p=1 - new_p, view_chunk=view_chunk, text_cfg=text_cfg,
            uncond_text=uncond_text,
            generator=torch.Generator(device=dev).manual_seed(
                _fold(self._seed, 3)))

        do_repaint = repaint_sampling and resampling_steps > 0
        T = num_inference_steps
        # T == 1: the only step is the last step, which never repaints
        undo = [self.scheduler.undo_step_coeffs(st, int(st.timesteps[i + 1]))
                for i in range(T - 1)] if do_repaint else []

        # per-step cost model
        fwd_per_step = 2 * (resampling_steps + 1) + V
        fwd_repaint = 2 + V

        steps_iter = range(T)
        if progress is not None:
            steps_iter = progress(steps_iter)
        total_fwd = 0
        init_downsampled_latent = None
        inter_x0, inter_rrg_x0 = [], []
        self.last_step_latents = []
        if on_cuda:
            torch.cuda.synchronize(dev)  # the preamble is not the denoise loop
        t_start = time.time()
        for i in steps_iter:
            use_repaint = do_repaint and i < T - 1
            inp = {"t": float(st.timesteps[i]), "coeffs": coeff_table[i],
                   "rrg_w": float(rrg_w[i]),
                   "bg_down": {s: tbl[i] for s, tbl in bg_down_tbl.items()},
                   "bg_view": {s: tbl[i] for s, tbl in bg_view_tbl.items()}}
            if use_repaint:
                inp["undo_s1mb"], inp["undo_sb"] = undo[i]
            if scripted_noise is not None:
                for k_, v_ in scripted_noise.items():
                    arr = v_[i] if isinstance(v_, (list, tuple)) else v_
                    inp[k_] = torch.as_tensor(arr, device=dev)
            lat, aux = self._denoise_step(ctx, lat, inp, use_repaint)
            self.last_step_latents.append(lat)
            total_fwd += fwd_per_step + (fwd_repaint if use_repaint else 0)
            if init_downsampled_latent is None:
                init_downsampled_latent = aux["init_downsampled_latent"]
            if self.verbose and i % self.log_freq == 0:
                inter_x0.append(aux["x0"])
                if rrg_w[i] > 10:
                    inter_rrg_x0.append(aux["rrg_x0"])
        if on_cuda:
            torch.cuda.synchronize(dev)
        elapsed = time.time() - t_start
        self.last_metrics = {
            "steps": T, "views": V, "unet_view_forwards": total_fwd,
            "denoise_seconds": elapsed,
            "unet_view_forwards_per_sec": total_fwd / max(elapsed, 1e-9),
            "preamble_seconds": t_start - t_fn0,
        }

        image_log: Dict[str, Any] = {}
        if self.verbose:
            image_log = self._image_log(
                init_downsampled_latent, text_cfg, guidance_scale, T, down_pad,
                bg_down_tbl, st, inter_x0, inter_rrg_x0)

        t_dec0 = time.time()
        imgs = torch.cat([self.decode_latents(lat[i:i + 1]) for i in range(B)])
        if on_cuda:
            torch.cuda.synchronize(dev)
        self.last_metrics["decode_seconds"] = time.time() - t_dec0
        if return_arrays:
            return imgs.cpu().numpy(), {"latent": lat.cpu().numpy(), **image_log}
        if grid:
            arr = make_grid(imgs.cpu().numpy(), nrow=B)[None]
            return to_pil(arr), image_log
        return to_pil(imgs), image_log

    def _image_log(self, init_down, text_cfg, guidance_scale, steps, down_pad,
                   bg_down_tbl, st, inter_x0, inter_rrg_x0) -> Dict[str, Any]:
        """The verbose image log: the low-resolution global image and the
        decoded intermediate x0 predictions."""
        log: Dict[str, Any] = {}
        decode = lambda xs: np.concatenate(
            [self.decode_latents(x).cpu().numpy() for x in xs])
        row = lambda dec: to_pil(make_grid(dec, nrow=len(dec))[None])[0]
        if init_down is not None:
            g_img, g_info = self.generate(
                init_down, text_cfg, guidance_scale=guidance_scale,
                num_inference_steps=steps, pad_spec=down_pad,
                bg_tables=bg_down_tbl or None, state=st)
            log["global_img"] = to_pil(g_img)[0]
            if g_info["inter_x0"]:
                log["global_img_inter_x0_imgs"] = row(decode(
                    [torch.as_tensor(x, device=self.device)
                     for x in g_info["inter_x0"]]))
        if inter_x0:
            log["intermediate_x0_imgs"] = row(decode(inter_x0))
        if inter_rrg_x0:
            log["intermediate_cascade_x0_imgs"] = {"rrg": row(decode(inter_rrg_x0))}
        return log
