"""Signal estimators: the ElasticDiffusion algorithm as functions on tensors.

  - unet_step: background pad -> UNet -> crop
  - obtain_latent_direction: the CFG pair
  - approximate_latent_direction: global direction with randomized resampling
  - compute_local_uncond_signal: local unconditional score over patch views
  - reduced_resolution_guidance: the analytic RRG gradient
  - undo_step: the repaint re-noising

Structure, as in the JAX package:
  - the resampling substeps' only sequential dependence is the RNG /
    exclude-mask pick chain; all 2*(rs+1) CFG forwards run as ONE batched
    UNet call
  - the view loop is ONE batched UNet call over all views plus the owner-map
    writeback; view_batch_size is a memory knob that chunks it
  - RRG's autograd is replaced by the closed form
    2*rrg_scale*(up(ref_x0) - x0)/numel
  - every random draw can be overridden by recorded values (ScriptedNoise,
    or the scripted_* arguments) so parity harnesses can inject the same
    randomness into both packages
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..ops.resample import (ResamplePlan, apply_resample, fill_in,
                            mix_with_prev, sample_pick_indices,
                            update_exclude_mask)
from ..ops.resize import nearest_resize
from ..ops.views import ViewPlan, gather_views, scatter_first_writer
from .background import PadSpec, crop_from_padding, pad_with_background


class ScriptedNoise(NamedTuple):
    """Optional recorded randomness for parity testing. Any field may be None.

    picks:  (rs+1, N) integers: final per-substep block picks (overrides the
            exclude/drop machinery entirely)
    repaint:(n_micro, B, C, H, W): repaint re-noising draws
    """

    picks: Optional[torch.Tensor] = None
    repaint: Optional[torch.Tensor] = None


def unet_step(bundle, x, t, context, pad_spec: PadSpec, step_bgs,
              add_text_embeds=None, add_time_ids=None):
    """background pad -> UNet -> crop. x: (B', C, h, w)."""
    x_in = pad_with_background(x, pad_spec, step_bgs)
    kwargs = {}
    if add_text_embeds is not None:
        kwargs = {"added_text_embeds": add_text_embeds,
                  "added_time_ids": add_time_ids}
    eps = bundle.apply_unet(x_in, t, context, **kwargs)
    return crop_from_padding(eps, pad_spec)


def obtain_latent_direction(bundle, latent, t, text_embeds_cfg, pad_spec,
                            step_bgs, add_text_embeds_cfg=None,
                            add_time_ids=None):
    """CFG pair in one batched call.

    text_embeds_cfg: (2B, 77, D) stacked [uncond; cond].
    Returns (direction, uncond_eps, cond_eps), all fp32.
    """
    B = latent.shape[0]
    x2 = torch.cat([latent, latent]).to(bundle.runtime.compute_dtype)
    tid = None
    if add_time_ids is not None:
        tid = add_time_ids.expand(2 * B, *add_time_ids.shape[1:])
    eps = unet_step(bundle, x2, t, text_embeds_cfg, pad_spec, step_bgs,
                    add_text_embeds=add_text_embeds_cfg, add_time_ids=tid)
    eps = eps.float()
    eps_u, eps_c = eps[:B], eps[B:]
    return eps_c - eps_u, eps_u, eps_c


def resolve_resample_picks(generator, n_sub: int, num_blocks: int,
                           drop_p: float, scripted_picks=None,
                           device=None) -> torch.Tensor:
    """The resampling loop's ONLY sequential dependence: the RNG /
    exclude-mask pick chain. Returns all substeps' picks (n_sub, N) so the
    UNet work can run as one batch. Substep 0 is the deterministic top-left
    pick; later substeps sample fresh sub-pixels avoiding the exclude mask
    and keep the previous pick with probability drop_p."""
    if scripted_picks is not None:
        return torch.as_tensor(scripted_picks, device=device)[:n_sub].long()
    dev = generator.device
    excl = torch.zeros((num_blocks, 4), dtype=torch.bool, device=dev)
    prev = torch.zeros((num_blocks,), dtype=torch.int64, device=dev)
    picks = []
    for s in range(n_sub):
        new_pick = sample_pick_indices(generator, excl, num_blocks)
        mixed = mix_with_prev(generator, new_pick, prev, drop_p)
        pick = torch.zeros_like(prev) if s == 0 else mixed
        excl = update_exclude_mask(excl, pick)
        prev = pick
        picks.append(pick)
    return torch.stack(picks)


class DirectionResult(NamedTuple):
    direction: torch.Tensor           # (B, C, H, W) fp32, fully filled
    init_downsampled_latent: torch.Tensor
    downsampled_latent: torch.Tensor  # last resampling substep's input
    uncond_score: torch.Tensor        # last substep's uncond eps (low-res)
    downsampled_direction: torch.Tensor  # nearest-downsample of the direction


def approximate_latent_direction(bundle, latent, generator, t, text_embeds_cfg,
                                 plan: ResamplePlan, pad_spec: PadSpec,
                                 step_bgs, resampling_steps: int, drop_p: float,
                                 add_text_embeds_cfg=None, add_time_ids=None,
                                 scripted_picks=None) -> DirectionResult:
    """Global CFG direction with randomized resampling.

    The UNet inputs of all substeps are downsamples of the SAME latent, so:
    (1) the pick chain derives every substep's pick, (2) ONE CFG-batched UNet
    call of batch 2*(rs+1)*B evaluates all substeps, (3) the fills are
    applied in substep order (a later substep overwrites an earlier one where
    they overlap). Draw for draw the same randomness and fill order as a
    sequential loop.
    """
    B, C, H, W = latent.shape
    N = plan.num_blocks
    n_sub = resampling_steps + 1
    latent32 = latent.float()

    picks = resolve_resample_picks(generator, n_sub, N, drop_p, scripted_picks,
                                   device=latent.device)
    pairs = [apply_resample(latent32, plan, picks[s]) for s in range(n_sub)]
    downs = torch.stack([p[0] for p in pairs])       # (n_sub, B, C, dh, dw)
    masks = [p[1] for p in pairs]                    # n_sub x (H, W)

    # ONE CFG-batched UNet call over all substeps: layout
    # [uncond s0..s{n-1} | cond s0..s{n-1}], each block batch n_sub*B
    dh, dw = plan.out_h, plan.out_w
    flat = downs.reshape(n_sub * B, C, dh, dw)
    x2 = torch.cat([flat, flat]).to(bundle.runtime.compute_dtype)
    uncond, cond = text_embeds_cfg[:B], text_embeds_cfg[B:]
    ctx = torch.cat([uncond.repeat(n_sub, 1, 1), cond.repeat(n_sub, 1, 1)])
    ate = None
    if add_text_embeds_cfg is not None:
        au, ac = add_text_embeds_cfg[:B], add_text_embeds_cfg[B:]
        ate = torch.cat([au.repeat(n_sub, 1), ac.repeat(n_sub, 1)])
    tid = None
    if add_time_ids is not None:
        tid = add_time_ids.expand(2 * n_sub * B, *add_time_ids.shape[1:])
    eps = unet_step(bundle, x2, t, ctx, pad_spec, step_bgs,
                    add_text_embeds=ate, add_time_ids=tid).float()
    eps_u = eps[:n_sub * B].reshape(n_sub, B, C, dh, dw)
    eps_c = eps[n_sub * B:].reshape(n_sub, B, C, dh, dw)
    directions = eps_c - eps_u                       # (n_sub, B, C, dh, dw)

    target = torch.zeros((B, C, H, W), dtype=torch.float32,
                         device=latent.device)
    filled = torch.zeros((H, W), dtype=torch.bool, device=latent.device)
    for s in range(n_sub):
        target, filled = fill_in(target, filled, directions[s], masks[s],
                                 fill_all=False)
    # fill_all at the final substep: positions still unfilled take the last
    # upsampled direction
    up_last = nearest_resize(directions[-1], (H, W))
    target = torch.where(filled, target, up_last)
    down_dir = nearest_resize(target, (dh, dw))
    return DirectionResult(direction=target,
                           init_downsampled_latent=downs[0],
                           downsampled_latent=downs[-1],
                           uncond_score=eps_u[-1],
                           downsampled_direction=down_dir)


def compute_local_uncond_signal(bundle, latent, t, uncond_embeds,
                                plan: ViewPlan, pad_spec: PadSpec, step_bgs,
                                uncond_pooled=None, add_time_ids=None,
                                view_batch_size: int = 0):
    """Local unconditional score over patch views.

    One batched UNet call over all V views, or chunks of view_batch_size
    views with a ragged last chunk (the same numbers either way).
    """
    B = latent.shape[0]
    V = plan.num_views
    views = gather_views(latent.to(bundle.runtime.compute_dtype), plan)
    vb = views.reshape(V * B, *views.shape[2:])
    ctx = uncond_embeds.repeat(V, 1, 1)
    pooled = None if uncond_pooled is None else uncond_pooled.repeat(V, 1)
    tid = None if add_time_ids is None else \
        add_time_ids.expand(V * B, *add_time_ids.shape[1:])

    chunk = view_batch_size * B if 0 < view_batch_size < V else V * B
    preds = []
    for lo in range(0, V * B, chunk):
        hi = min(lo + chunk, V * B)
        preds.append(unet_step(
            bundle, vb[lo:hi], t, ctx[lo:hi], pad_spec, step_bgs,
            add_text_embeds=None if pooled is None else pooled[lo:hi],
            add_time_ids=None if tid is None else tid[lo:hi]))
    preds = torch.cat(preds) if len(preds) > 1 else preds[0]
    preds = preds.reshape(V, B, *preds.shape[1:]).float()
    return scatter_first_writer(preds, plan)


def _ddim_from_coeffs(model_output, sample, coeffs):
    sa_t, s1a_t, sa_p, s1a_p = (float(c) for c in coeffs)
    x0 = (sample - s1a_t * model_output) / sa_t
    prev = sa_p * x0 + s1a_p * model_output
    return prev, x0


def reduced_resolution_guidance(x0_full, downsampled_latent, uncond_score,
                                downsampled_direction, guidance_scale,
                                rrg_scale, ddim_coeffs):
    """Analytic RRG gradient: low-res DDIM x0 from cached scores,
    nearest-upsampled, pulled toward with d/dx0 [rrg_scale * MSE] sign-flipped:
        cascade = 2 * rrg_scale * (up(ref_x0) - x0) / numel
    """
    noise_low = uncond_score + guidance_scale * downsampled_direction
    _, ref_x0 = _ddim_from_coeffs(noise_low, downsampled_latent, ddim_coeffs)
    ref_up = nearest_resize(ref_x0, (x0_full.shape[-2], x0_full.shape[-1]))
    numel = x0_full.shape[1] * x0_full.shape[2] * x0_full.shape[3]
    return 2.0 * float(rrg_scale) * (ref_up - x0_full) / numel, ref_x0


def undo_step(sample, generator, sqrt_1m_betas, sqrt_betas, scripted=None):
    """Repaint re-noising: n sequential micro-steps with fresh noise each.
    A Python loop of small launches (1000 // steps of them)."""
    n = len(sqrt_1m_betas)
    x = sample
    for i in range(n):
        if scripted is not None:
            noise = scripted[i]
        else:
            noise = torch.randn(x.shape, generator=generator, dtype=x.dtype,
                                device=x.device)
        x = float(sqrt_1m_betas[i]) * x + float(sqrt_betas[i]) * noise
    return x
