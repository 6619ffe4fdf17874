"""ElasticDiffusion pipeline: the public API of the port.

Counterpart of ``elasticdiffusion_tpu/core/pipeline.py``. One denoise step
is: the global CFG direction from resampled low-resolution forwards, the
local unconditional score from one batched pass over patch views, a DDIM
update, optionally the repaint re-estimation, and the analytic
reduced-resolution guidance. With a ControlNet bundle and a
``condition_image``, every UNet forward of the step takes the ControlNet's
residuals. PyTorch runs eagerly, so the step is a plain
method and the timestep loop a Python loop; per-step constants (DDIM
coefficients, RRG weights, background tables) are computed before the loop.

The final decode is monolithic (``decode_latents``), or with
``tiled_decoder=True`` the exact halo decode of ``parallel/halo_decode.py``
(``halo_decode``) or, with ``use_halo_decode = False``, the reference's
overlap-averaged tiles (``tiled_decode``). ``checkpoint_path`` /
``checkpoint_every`` save the latent, the step and the step generator's
state to an ``.npz`` file, and ``resume_from`` continues from one.

With a mesh (``mesh=`` or ``RuntimeConfig.mesh_shape``, see
``parallel/sharding.py``), every rank runs this code: the weights are
broadcast from the first rank, each estimator's UNet batch is split over
the 'views' axis, and the halo decode splits its stage b into bands of
latent rows; every rank ends with the same latent and image.

Runs on the GPU unless the caller passes ``device="cpu"``.
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
from ..ops.resize import nearest_resize
from ..ops.views import build_view_plan, get_views_latent
from ..parallel.sharding import (collective_inventory, is_first_rank,
                                 make_mesh, put_replicated,
                                 reset_collective_inventory)
from ..sched.ddim import DDIMScheduler
from ..sched.weight_schedulers import (CosineScheduler, make_rrg_scheduler,
                                       rrg_weight_table)
from ..utils import trace
from ..utils.image import make_grid, to_pil
from ..utils.timeit import timelog
from . import background, signals
from .background import PadSpec


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
    # SDXL 'text_time' conditioning; None for the other families
    add_text_cfg: Optional[torch.Tensor] = None
    uncond_pooled: Optional[torch.Tensor] = None
    add_time_ids: Optional[torch.Tensor] = None
    # the ControlNet conditions of every estimator call
    # (``signals.image_conditions``); None without
    controlnet_cond: Optional[signals.ControlNetConditions] = None
    controlnet_scale: float = 1.0


@dataclass
class _Schedule:
    """The per-step constants of one generate_image call: DDIM timesteps
    and coefficients, RRG weights, background tables and, when repainting,
    the undo coefficients of every step but the last."""

    state: Any
    coeff_table: np.ndarray
    rrg_w: np.ndarray
    bg_down: Dict[str, torch.Tensor]
    bg_view: Dict[str, torch.Tensor]
    undo: list

    def inputs(self, i: int) -> Tuple[Dict[str, Any], bool]:
        """(inp of step i for ``_denoise_step``, whether it repaints). The
        last step never repaints."""
        inp = {"t": float(self.state.timesteps[i]),
               "coeffs": self.coeff_table[i], "rrg_w": float(self.rrg_w[i]),
               "bg_down": {s: tbl[i] for s, tbl in self.bg_down.items()},
               "bg_view": {s: tbl[i] for s, tbl in self.bg_view.items()}}
        repaint = i < len(self.undo)
        if repaint:
            inp["undo_s1mb"], inp["undo_sb"] = self.undo[i]
        return inp, repaint


class ElasticDiffusion:
    """The reference class's API on PyTorch.

    `view_batch_size` defaults to 0 = "all views in one batched call"; set
    0 < view_batch_size < num_views to chunk the view pass as a memory knob
    (the same numbers either way). The attribute may be changed between
    calls, and so may `use_halo_decode` (True: ``tiled_decoder=True`` takes
    the exact ``halo_decode``; False: the overlap-averaged
    ``tiled_decode``).

    `low_vram` makes ``tiled_decode``'s tiles overlap by half. The JAX
    package's ``low_vram`` also rematerialises the UNet for a backward pass,
    which changes nothing in an inference forward: the port has no knob for
    it.

    `mesh`: a ``parallel/sharding.py`` mesh; None builds one from
    ``runtime.mesh_shape`` (None for one rank), before the bundle is loaded
    so that it lands on the rank's GPU. Every model of the bundle is then
    broadcast from the mesh's first rank.
    """

    use_halo_decode = True

    def __init__(self, device="cuda", sd_version: str = "2.0",
                 verbose: bool = False, log_freq: int = 5,
                 view_batch_size: int = 0, low_vram: bool = False,
                 checkpoint_dir: Optional[str] = None,
                 controlnet_model: Optional[str] = None,
                 tokenizer_dirs=None,
                 runtime: Optional[RuntimeConfig] = None,
                 bundle: Optional[ModelBundle] = None,
                 mesh=None):
        self.sd_version = sd_version
        self.low_vram = low_vram
        self.verbose = verbose
        self.log_freq = log_freq
        self.view_batch_size = view_batch_size
        if mesh is None:
            rt = runtime or (bundle.runtime if bundle is not None
                             else RuntimeConfig())
            dev_type = (bundle.device if bundle is not None
                        else resolve_device(device)).type
            mesh = make_mesh(rt.mesh_shape, rt.mesh_axis_names,
                             device_type=dev_type)
        self.mesh = mesh
        if bundle is None:
            bundle = load_bundle(sd_version, runtime=runtime or RuntimeConfig(),
                                 checkpoint_dir=checkpoint_dir,
                                 controlnet_model=controlnet_model,
                                 tokenizer_dirs=tokenizer_dirs, device=device)
        elif device is not None and \
                resolve_device(device).type != bundle.device.type:
            raise ValueError(f"bundle lives on {bundle.device}, not on "
                             f"{device!r}")
        self.bundle = bundle
        for model in {id(m): m for m in (
                bundle.unet, bundle.controlnet, bundle.vae_fp32, bundle.vae,
                *bundle.text_models) if m is not None}.values():
            put_replicated(model, mesh)
        self.controlnet_model = controlnet_model
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
        """(text embeddings, pooled embedding), both fp32. SDXL: the
        penultimate hidden states of both encoders joined on the last dim,
        and the projected pooled output of the second."""
        b = self.bundle
        if b.config.is_xl:
            _, pen0, _ = b.encode_text(b.tokenizers[0](prompts), 0)
            _, pen1, pooled = b.encode_text(b.tokenizers[1](prompts), 1)
            return torch.cat([pen0, pen1], dim=-1).float(), pooled.float()
        ids = b.tokenizers[0](prompts)
        last, _, _ = b.encode_text(ids, 0)
        return last.float(), last.float()

    def _get_add_time_ids(self, original_size, crops_coords_top_left,
                          target_size) -> torch.Tensor:
        """SDXL micro-conditioning ids, (1, 6) fp32."""
        ids = list(original_size) + list(crops_coords_top_left) \
            + list(target_size)
        return torch.tensor([ids], dtype=torch.float32, device=self.device)

    def decode_latents(self, latents) -> torch.Tensor:
        img = self.bundle.vae_decode(
            latents.float() / self.bundle.config.vae.scaling_factor)
        return (img.float() / 2 + 0.5).clamp(0.0, 1.0)

    def halo_decode(self, latents) -> torch.Tensor:
        """The exact large-size decode (``parallel/halo_decode.py``): bands
        of stage b over the mesh's 'views' axis, else monolithic or
        streamed stage b by its predictive choice; equal to
        ``decode_latents`` up to the order of sums."""
        return self._halo_decode(latents)[0]

    def _halo_decode(self, latents) -> Tuple[torch.Tensor, str]:
        """``halo_decode`` and the branch it took ('mesh', 'monolithic',
        'streamed' or 'bands')."""
        from ..parallel.halo_decode import halo_decode
        img, branch = halo_decode(self.bundle, latents.float()
                                  / self.bundle.config.vae.scaling_factor,
                                  mesh=self.mesh, return_branch=True)
        return (img.float() / 2 + 0.5).clamp(0.0, 1.0), branch

    def _final_decode(self, latents, tiled_decoder: bool
                      ) -> Tuple[torch.Tensor, str]:
        """The final decode of one image and its route: 'plain'
        (``decode_latents``), 'tiled' (``tiled_decode``) or 'halo:' and
        the branch ``halo_decode`` took."""
        if not tiled_decoder:
            return self.decode_latents(latents), "plain"
        if not self.use_halo_decode:
            return self.tiled_decode(latents), "tiled"
        img, branch = self._halo_decode(latents)
        return img, "halo:" + branch

    def tiled_decode(self, latents) -> torch.Tensor:
        """The reference's overlap-averaged tiled decode: the latent is
        zero-padded, tiles of sample_size // 4 latent rows and columns
        (with `pad` rows of context a side) are decoded one by one, and the
        overlapping cores averaged. An approximation; ``halo_decode`` is
        exact."""
        B, _, lh, lw = latents.shape
        vsf = self.vae_scale_factor
        sample = self.bundle.sample_size
        core = stride = sample // 4
        pad = sample // vsf * 3
        if self.low_vram:
            stride, pad = core // 2, core
        padded = torch.nn.functional.pad(latents, (pad, pad, pad, pad))
        image = torch.zeros((B, 3, lh * vsf, lw * vsf), device=latents.device)
        count = torch.zeros_like(image)
        p = pad * vsf
        for a, b, c, d in get_views_latent(lh, lw, core, core, stride):
            dec = self.decode_latents(padded[:, :, a:b + 2 * pad, c:d + 2 * pad])
            core_px = dec[:, :, p:dec.shape[2] - p, p:dec.shape[3] - p]
            rows = slice(a * vsf, a * vsf + core_px.shape[2])
            cols = slice(c * vsf, c * vsf + core_px.shape[3])
            image[:, :, rows, cols] += core_px
            count[:, :, rows, cols] += 1.0
        return image / count

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
                  resampling_steps: int, picks, which: str = "main"):
        """Global direction + local unconditional score at one latent;
        `which` names the pass in the trace ('main' or 'repaint')."""
        with trace.span("direction", rs=resampling_steps, **{"pass": which}):
            res = signals.approximate_latent_direction(
                self.bundle, lat, ctx.generator, t, ctx.text_cfg,
                ctx.resample_plan, ctx.down_pad, bg_down, resampling_steps,
                ctx.drop_p, add_text_embeds_cfg=ctx.add_text_cfg,
                add_time_ids=ctx.add_time_ids, scripted_picks=picks,
                controlnet_cond=ctx.controlnet_cond,
                controlnet_scale=ctx.controlnet_scale, mesh=self.mesh)
        local = signals.compute_local_uncond_signal(
            self.bundle, lat, t, ctx.uncond_text, ctx.view_plan, ctx.view_pad,
            bg_view, uncond_pooled=ctx.uncond_pooled,
            add_time_ids=ctx.add_time_ids, view_batch_size=ctx.view_chunk,
            controlnet_cond=ctx.controlnet_cond,
            controlnet_scale=ctx.controlnet_scale, mesh=self.mesh)
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
                                          inp.get("picks_repaint"), "repaint")
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

    def _context(self, prompts, negative_prompts, height: int, width: int,
                 guidance_scale: float, resampling_steps: int, new_p: float,
                 condition_image=None,
                 controlnet_conditioning_scale: float = 1.0) -> _StepContext:
        """What every step of one call shares: plans, pads, text
        conditioning, the ControlNet condition and the step generator
        (seeded from the base seed)."""
        b = self.bundle
        dev = self.device
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
        V = view_plan.num_views
        vbs = self.runtime.view_batch_size or self.view_batch_size

        # text
        uncond_text, uncond_pooled = self.get_text_embeds(negative_prompts)
        cond_text, cond_pooled = self.get_text_embeds(prompts)
        add_text_cfg = add_time_ids = uncond_pooled_arg = None
        if b.config.is_xl:
            add_text_cfg = torch.cat([uncond_pooled, cond_pooled])
            # the reference's micro-conditioning quirk: original and target
            # size are (4H, 4W), not the size asked for
            default_size = (4 * height, 4 * width)
            add_time_ids = self._get_add_time_ids(default_size, (0, 0),
                                                  default_size)
            uncond_pooled_arg = uncond_pooled

        # ControlNet condition, at the downsampled size in pixels: padded
        # for the direction, upsampled and cropped for the views, once
        cn_cond = None
        if condition_image is not None:
            if b.controlnet is None:
                raise ValueError("condition_image needs a bundle with a "
                                 "ControlNet (controlnet_model=...)")
            cn_cond = torch.as_tensor(condition_image, dtype=torch.float32,
                                      device=dev)
            if cn_cond.dim() == 3:
                cn_cond = cn_cond[None]
            if cn_cond.shape[1] != 3 or cn_cond.shape[0] not in (1, B):
                raise ValueError(f"condition must be (1|{B}, 3, h, w) in "
                                 f"[0, 1], got {tuple(cn_cond.shape)}")
            cn_cond = nearest_resize(cn_cond, (down_h * vsf, down_w * vsf))
            cn_cond = signals.image_conditions(
                cn_cond.expand(B, *cn_cond.shape[1:]), down_pad, view_plan, B,
                vsf, b.controlnet.dtype)

        return _StepContext(
            resample_plan=resample_plan, view_plan=view_plan,
            down_pad=down_pad,
            view_pad=PadSpec(*view_plan.out_shape, m, m),
            guidance_scale=guidance_scale, resampling_steps=resampling_steps,
            drop_p=1 - new_p, view_chunk=vbs if vbs and vbs < V else 0,
            text_cfg=torch.cat([uncond_text, cond_text]),
            uncond_text=uncond_text,
            generator=torch.Generator(device=dev).manual_seed(
                _fold(self._seed, 3)),
            add_text_cfg=add_text_cfg, uncond_pooled=uncond_pooled_arg,
            add_time_ids=add_time_ids, controlnet_cond=cn_cond,
            controlnet_scale=controlnet_conditioning_scale)

    def _schedule(self, ctx: _StepContext, num_inference_steps: int,
                  rrg_stop_t: float, rrg_init_weight: float,
                  rrg_scherduler_cls, cosine_scale: float,
                  repaint: bool) -> _Schedule:
        """The per-step constants; the backgrounds from the base seed."""
        b = self.bundle
        T = num_inference_steps
        st = self.scheduler.set_timesteps(T)
        rrg_sched = make_rrg_scheduler(rrg_scherduler_cls, T, rrg_stop_t,
                                       rrg_init_weight, cosine_scale)
        bg_seed = _fold(self._seed, 2)
        tables = [background.make_background_table(
            b, st.timesteps, pad, seed, self.scheduler)
            if pad.needs_padding else {}
            for pad, seed in ((ctx.down_pad, bg_seed),
                              (ctx.view_pad, _fold(bg_seed, 1)))]
        # T == 1: the only step is the last step, which never repaints
        undo = [self.scheduler.undo_step_coeffs(st, int(st.timesteps[i + 1]))
                for i in range(T - 1)] if repaint else []
        return _Schedule(st, self.scheduler.coeff_tables(st),
                         rrg_weight_table(rrg_sched, T), *tables, undo)

    @timelog.time_function
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
        {'latent': final latent, ...}.

        condition_image: (1 | B, 3, h, w) or (3, h, w) in [0, 1], the
        ControlNet condition (``apps/preprocessors.py`` makes one); it is
        nearest-resized to the downsampled size in pixels when it has
        another size. Needs a bundle loaded with a ControlNet.

        tiled_decoder: decode with ``halo_decode`` (``use_halo_decode``, the
        default) or ``tiled_decode``. checkpoint_path / checkpoint_every:
        after every `checkpoint_every`-th step, the first rank writes the
        latent (``latent``), the step (``step``) and the step generator's
        state (``generator``) to the ``.npz`` file `checkpoint_path`.
        resume_from: such a file; the run restores the latent and the
        generator and goes on at the step after the saved one, so that it
        ends with the uninterrupted run's latent.

        ``last_metrics`` after the call: ``steps``, ``views``,
        ``unet_view_forwards`` (the UNet rows of the step loop, counted at
        ``ModelBundle.apply_unet``; with a mesh, this rank's rows, padding
        included), ``unet_graph_replays`` and ``unet_graph_captures`` (the
        step loop's UNet calls replayed from a CUDA graph and captured into
        one, ``models/unet_graphs.py``; 0 on the CPU), with a ControlNet
        ``controlnet_view_forwards`` (its rows in the step loop, counted at
        ``ModelBundle.apply_unet``), ``controlnet_graph_replays`` and
        ``controlnet_graph_captures`` (its calls replayed from a CUDA graph
        and captured into one; 0 on the CPU) and
        ``controlnet_device_seconds`` (the summed stream time of its part
        of those calls, ``CallClock``; the host clock on the CPU), ``preamble_seconds``, ``denoise_seconds`` and
        ``decode_seconds`` (host clock, each phase ended by a
        synchronisation on the GPU) and ``decode_route`` (``plain``,
        ``tiled`` or ``halo:`` and the branch ``halo_decode`` took). With a
        mesh, ``last_metrics["collectives"]`` holds this rank's
        ``collective_inventory`` of the call. With a tracer set
        (``utils/trace.py``), the call records its spans."""
        with trace.span("image") as image:
            t_fn0 = time.time_ns()
            preamble = trace.begin("preamble", t_fn0, peak=self.device)
            if self.mesh is not None:
                reset_collective_inventory()
            b = self.bundle
            dev = self.device
            on_cuda = dev.type == "cuda"
            if isinstance(prompts, str):
                prompts = [prompts]
            if isinstance(negative_prompts, str):
                negative_prompts = [negative_prompts] * len(prompts)
            B = len(prompts)
            with trace.span("context"):
                ctx = self._context(prompts, negative_prompts, height, width,
                                    guidance_scale, resampling_steps, new_p,
                                    condition_image,
                                    controlnet_conditioning_scale)
            vsf = self.vae_scale_factor
            lat_h, lat_w = height // vsf, width // vsf
            # a demo that changes sizes keeps no graphs of the old ones
            graphs = b.unet_graphs
            graphs.for_image((height, width, B, ctx.view_chunk))

            # initial latent
            if latents is None:
                gen_init = torch.Generator(device=dev).manual_seed(
                    _fold(self._seed, 1))
                lat = torch.randn((B, b.in_channels, lat_h, lat_w),
                                  generator=gen_init, device=dev)
            else:
                lat = torch.as_tensor(latents, dtype=torch.float32, device=dev)

            do_repaint = repaint_sampling and resampling_steps > 0
            with trace.span("schedule"):
                sched = self._schedule(ctx, num_inference_steps, rrg_stop_t,
                                       rrg_init_weight, rrg_scherduler_cls,
                                       cosine_scale, do_repaint)
            T = num_inference_steps
            V = ctx.view_plan.num_views
            image.set(height=height, width=width, steps=T,
                      rs=resampling_steps, views=V, B=B)

            # latent checkpoint/resume: the latent, the step and the generator
            start_step = 0
            if resume_from is not None:
                ck = np.load(resume_from)
                if tuple(ck["latent"].shape) != tuple(lat.shape):
                    raise ValueError(f"checkpoint latent {ck['latent'].shape} "
                                     f"!= {tuple(lat.shape)}")
                lat = torch.as_tensor(ck["latent"], device=dev)
                ctx.generator.set_state(torch.from_numpy(ck["generator"]))
                start_step = int(ck["step"]) + 1

            steps_iter = range(start_step, T)
            if progress is not None:
                steps_iter = progress(steps_iter)
            init_downsampled_latent = None
            inter_x0, inter_rrg_x0 = [], []
            self.last_step_latents = []
            if on_cuda:
                torch.cuda.synchronize(dev)  # the preamble is not the loop
            t_start = time.time_ns()
            preamble.end(t_start)
            denoise = trace.begin("denoise", t_start, peak=dev)
            rows0 = b.unet_rows
            replays0, captures0 = graphs.replays, graphs.captures
            if b.controlnet is not None:
                cn0 = (b.controlnet_rows, b.controlnet_graph_replays,
                       b.controlnet_graph_captures)
                b.controlnet_clock.start()
            for i in steps_iter:
                inp, use_repaint = sched.inputs(i)
                if scripted_noise is not None:
                    for k_, v_ in scripted_noise.items():
                        arr = v_[i] if isinstance(v_, (list, tuple)) else v_
                        inp[k_] = torch.as_tensor(arr, device=dev)
                with trace.span("step", i=i, repaint=use_repaint):
                    lat, aux = self._denoise_step(ctx, lat, inp, use_repaint)
                self.last_step_latents.append(lat)
                if init_downsampled_latent is None:
                    init_downsampled_latent = aux["init_downsampled_latent"]
                if self.verbose and i % self.log_freq == 0:
                    inter_x0.append(aux["x0"])
                    if sched.rrg_w[i] > 10:
                        inter_rrg_x0.append(aux["rrg_x0"])
                if checkpoint_path and checkpoint_every \
                        and (i + 1) % checkpoint_every == 0 \
                        and is_first_rank():
                    np.savez(checkpoint_path, latent=lat.cpu().numpy(), step=i,
                             generator=ctx.generator.get_state().numpy())
            rows = b.unet_rows - rows0
            # the decode holds no copy of the image's conditions
            ctx.controlnet_cond = None
            if on_cuda:
                torch.cuda.synchronize(dev)
            t_end = time.time_ns()
            denoise.end(t_end)
            self.last_metrics = {
                "steps": T, "views": V, "unet_view_forwards": rows,
                "unet_graph_replays": graphs.replays - replays0,
                "unet_graph_captures": graphs.captures - captures0,
                "denoise_seconds": (t_end - t_start) / 1e9,
                "preamble_seconds": (t_start - t_fn0) / 1e9,
            }
            if b.controlnet is not None:
                self.last_metrics.update(
                    controlnet_view_forwards=b.controlnet_rows - cn0[0],
                    controlnet_graph_replays=b.controlnet_graph_replays - cn0[1],
                    controlnet_graph_captures=(b.controlnet_graph_captures
                                               - cn0[2]),
                    controlnet_device_seconds=b.controlnet_clock.read())

            image_log: Dict[str, Any] = {}
            if self.verbose:
                if tiled_decoder:
                    decode = self.halo_decode if self.use_halo_decode \
                        else self.tiled_decode
                else:
                    decode = self.decode_latents
                image_log = self._image_log(
                    init_downsampled_latent, ctx, T, sched, inter_x0,
                    inter_rrg_x0, decode)

            t_dec0 = time.time_ns()
            decoding = trace.begin("decode", t_dec0, peak=dev)
            decoded = [self._final_decode(lat[i:i + 1], tiled_decoder)
                       for i in range(B)]
            imgs = torch.cat([img for img, _ in decoded])
            route = decoded[-1][1]
            if on_cuda:
                torch.cuda.synchronize(dev)
            t_dec1 = time.time_ns()
            decoding.end(t_dec1, route=route)
            self.last_metrics["decode_seconds"] = (t_dec1 - t_dec0) / 1e9
            self.last_metrics["decode_route"] = route
            if self.mesh is not None:
                self.last_metrics["collectives"] = collective_inventory()
            if return_arrays:
                return imgs.cpu().numpy(), {"latent": lat.cpu().numpy(),
                                            **image_log}
            if grid:
                arr = make_grid(imgs.cpu().numpy(), nrow=B)[None]
                return to_pil(arr), image_log
            return to_pil(imgs), image_log

    def _image_log(self, init_down, ctx: _StepContext, steps: int,
                   sched: _Schedule, inter_x0, inter_rrg_x0,
                   decode_fn) -> Dict[str, Any]:
        """The verbose image log: the low-resolution global image and the
        decoded intermediate x0 predictions (these through `decode_fn`, the
        final decode's route)."""
        log: Dict[str, Any] = {}
        decode = lambda fn, xs: np.concatenate(
            [fn(x).cpu().numpy() for x in xs])
        row = lambda dec: to_pil(make_grid(dec, nrow=len(dec))[None])[0]
        if init_down is not None:
            g_img, g_info = self.generate(
                init_down, ctx.text_cfg, ctx.add_text_cfg,
                guidance_scale=ctx.guidance_scale, num_inference_steps=steps,
                add_time_ids=ctx.add_time_ids, pad_spec=ctx.down_pad,
                bg_tables=sched.bg_down or None, state=sched.state)
            log["global_img"] = to_pil(g_img)[0]
            if g_info["inter_x0"]:
                log["global_img_inter_x0_imgs"] = row(decode(
                    self.decode_latents,
                    [torch.as_tensor(x, device=self.device)
                     for x in g_info["inter_x0"]]))
        if inter_x0:
            log["intermediate_x0_imgs"] = row(decode(decode_fn, inter_x0))
        if inter_rrg_x0:
            log["intermediate_cascade_x0_imgs"] = {
                "rrg": row(decode(decode_fn, inter_rrg_x0))}
        return log
