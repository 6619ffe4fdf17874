"""PCA score visualizer of the port.

Counterpart of ``elasticdiffusion_tpu/apps/pca_scores.py``: a plain SD
sampling loop (CFG DDIM) that, every ``log_freq`` steps, projects the CFG
direction and the unconditional score onto their first three principal
components as RGB and decodes the step's x0 prediction, then writes those
images and the final one, and reports the CUDA allocator's memory.

    python -m elasticdiffusion_tpu_torch.apps.pca_scores --sd_version 1.5 \\
        --checkpoint_dir ckpt/sd15 --steps 50 --log_freq 5
"""

from __future__ import annotations

import argparse
import os
from datetime import datetime

import numpy as np
import torch


def _pca3(flat: np.ndarray) -> np.ndarray:
    """(N, C) -> (N, 3): scikit-learn's ``PCA(n_components=3).fit_transform``
    as it runs on a tall input (N >= 10 C, its 'covariance_eigh' solver):
    eigenvectors of the covariance, largest first, each signed so that its
    entry of largest magnitude is positive, applied to the centred rows."""
    n = flat.shape[0]
    mean = flat.mean(axis=0)
    cov = flat.T @ flat - n * mean[:, None] * mean[None, :]
    cov /= n - 1
    _, vecs = np.linalg.eigh(cov)
    comp = np.flip(vecs, axis=1).T[:3]
    lead = np.abs(comp).argmax(axis=1)
    comp *= np.sign(comp[np.arange(len(comp)), lead])[:, None]
    return flat @ comp.T - mean[None, :] @ comp.T


def pca_to_rgb(score_nchw: np.ndarray) -> np.ndarray:
    """(B, C, H, W) score -> (B, 3, H, W) in [0, 1]: per image, the first
    three principal components over the channel axis, each scaled to
    [0, 1]."""
    B, C, H, W = score_nchw.shape
    out = np.zeros((B, 3, H, W), np.float32)
    for b in range(B):
        comp = _pca3(score_nchw[b].reshape(C, H * W).T)  # (HW, 3)
        comp = (comp - comp.min(0)) / np.maximum(comp.max(0) - comp.min(0), 1e-8)
        out[b] = comp.T.reshape(3, H, W)
    return out


def memory_stats() -> dict:
    """The CUDA allocator's memory per visible device, in MiB: in use now,
    the peak, and the device's total. Empty without CUDA."""
    stats = {}
    if not torch.cuda.is_available():
        return stats
    for i in range(torch.cuda.device_count()):
        s = torch.cuda.memory_stats(i)
        stats[f"cuda:{i}"] = {
            "bytes_in_use_mb": round(s.get("allocated_bytes.all.current", 0)
                                     / 2**20, 1),
            "peak_bytes_mb": round(s.get("allocated_bytes.all.peak", 0)
                                   / 2**20, 1),
            "bytes_limit_mb": round(torch.cuda.get_device_properties(i)
                                    .total_memory / 2**20, 1)}
    return stats


class VanillaLDM:
    """Plain SD sampler with per-step score capture."""

    def __init__(self, device="cuda", sd_version="2.0", checkpoint_dir=None,
                 bundle=None, log_freq=5):
        from ..core.pipeline import ElasticDiffusion
        self.pipe = ElasticDiffusion(device=device, sd_version=sd_version,
                                     checkpoint_dir=checkpoint_dir,
                                     bundle=bundle, log_freq=log_freq)
        self.log_freq = log_freq

    @torch.no_grad()
    def generate_image(self, prompts, negative_prompts="", height=512,
                       width=512, num_inference_steps=50, guidance_scale=7.5,
                       seed=0, latents=None):
        """(final image (B, 3, H, W) in [0, 1], {'direction_pca',
        'uncond_pca', 'inter_x0'}: lists of arrays, one per logged step).
        `latents` is the initial latent; by default it is drawn from the
        seed."""
        from ..core import signals
        from ..core.background import PadSpec
        from ..core.pipeline import _fold
        from ..sched.ddim import DDIMScheduler

        p = self.pipe
        b = p.bundle
        p.seed_everything(seed)
        if isinstance(prompts, str):
            prompts = [prompts]
        if isinstance(negative_prompts, str):
            negative_prompts = [negative_prompts] * len(prompts)
        uncond, up = p.get_text_embeds(negative_prompts)
        cond, cp = p.get_text_embeds(prompts)
        text_cfg = torch.cat([uncond, cond])
        add_cfg = torch.cat([up, cp]) if b.config.is_xl else None
        tids = p._get_add_time_ids((height, width), (0, 0), (height, width)) \
            if b.config.is_xl else None

        st = p.scheduler.set_timesteps(num_inference_steps)
        coeffs = p.scheduler.coeff_tables(st)
        vsf = p.vae_scale_factor
        shape = (len(prompts), b.in_channels, height // vsf, width // vsf)
        if latents is None:
            gen = torch.Generator(device=p.device).manual_seed(_fold(seed, 1))
            lat = torch.randn(shape, generator=gen, device=p.device)
        else:
            lat = torch.as_tensor(latents, dtype=torch.float32, device=p.device)
        pad = PadSpec(shape[-2], shape[-1], b.config.min_latent_size,
                      b.config.min_latent_size)

        logs = {"direction_pca": [], "uncond_pca": [], "inter_x0": []}
        for i in range(num_inference_steps):
            direction, eps_u, _ = signals.obtain_latent_direction(
                b, lat, float(st.timesteps[i]), text_cfg, pad, {},
                add_text_embeds_cfg=add_cfg, add_time_ids=tids)
            pred = eps_u + guidance_scale * direction
            lat, x0 = DDIMScheduler.step_from_coeffs(pred, lat.float(),
                                                     coeffs[i])
            if i % self.log_freq == 0:
                logs["direction_pca"].append(
                    pca_to_rgb(direction.float().cpu().numpy()))
                logs["uncond_pca"].append(
                    pca_to_rgb(eps_u.float().cpu().numpy()))
                logs["inter_x0"].append(p.decode_latents(x0).cpu().numpy())
        img = p.decode_latents(lat).cpu().numpy()
        return img, logs


def main(argv=None):
    """Run one command line; returns the directory the images went to."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--prompt", type=str, default="a photo of the santorini")
    ap.add_argument("--negative", type=str, default="")
    ap.add_argument("--sd_version", type=str, default="2.0")
    ap.add_argument("--H", type=int, default=512)
    ap.add_argument("--W", type=int, default=512)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--guidance_scale", type=float, default=7.5)
    ap.add_argument("--log_freq", type=int, default=5)
    ap.add_argument("--outdir", type=str, default="results_log/pca/")
    ap.add_argument("--checkpoint_dir", type=str, default=None)
    opt = ap.parse_args(argv)

    from ..utils.image import to_pil

    ldm = VanillaLDM(sd_version=opt.sd_version,
                     checkpoint_dir=opt.checkpoint_dir, log_freq=opt.log_freq)
    img, logs = ldm.generate_image(opt.prompt, opt.negative, opt.H, opt.W,
                                   opt.steps, opt.guidance_scale, opt.seed)

    stamp = datetime.now().strftime("%Y-%m-%d %H:%M:%S")
    out = os.path.join(opt.outdir, f"{stamp}_{opt.seed}")
    os.makedirs(out, exist_ok=True)
    to_pil(img)[0].save(f"{out}/final.png")
    for k in ("direction_pca", "uncond_pca", "inter_x0"):
        for i, arr in enumerate(logs[k]):
            to_pil(np.clip(arr, 0, 1))[0].save(f"{out}/{k}_{i}.png")
    print(f"[INFO] saved to {out}")
    for dev, s in memory_stats().items():
        print(f"[mem] {dev}: {s}")
    return out


if __name__ == "__main__":
    main()
