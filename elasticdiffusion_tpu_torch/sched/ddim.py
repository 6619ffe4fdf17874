"""DDIM scheduler (eta = 0): numpy tables, pure update functions.

Reproduces the diffusers DDIMScheduler behaviour that Stable Diffusion's
configs pin down:

  - scaled_linear betas: linspace(sqrt(b0), sqrt(b1), T)**2
  - leading timestep spacing with steps_offset:
      timesteps = (arange(n) * (T // n)).round()[::-1] + steps_offset
  - the update returns (prev_sample, pred_original_sample) with
      x0   = (x - sqrt(1-a_t) * eps) / sqrt(a_t)
      prev = sqrt(a_prev) * x0 + sqrt(1-a_prev) * eps
    where a_prev = alphas_cumprod[t - T//n] (or alphas_cumprod[0] when the
    index goes negative, since set_alpha_to_one=False for all SD configs)
  - add_noise(x0, eps, t) = sqrt(a_t) * x0 + sqrt(1-a_t) * eps
  - scale_model_input = identity for DDIM
  - the repaint re-noise: T//n micro-steps
      x <- sqrt(1-beta_{t+i}) x + sqrt(beta_{t+i}) eps_i

All tables are numpy constants computed once on the host; the per-step
coefficients are Python floats, so the update functions work on tensors of
any device without a transfer. ``step`` is the eager update at a Python
step index, in fp32 whatever the sample's dtype.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..configs import DDIMConfig


@dataclass(frozen=True)
class DDIMState:
    """Immutable schedule tables for one (config, num_inference_steps) pair."""

    config: DDIMConfig
    num_inference_steps: int
    timesteps: np.ndarray        # (n,) int64, descending
    betas: np.ndarray            # (T,) float64
    alphas_cumprod: np.ndarray   # (T,) float64
    final_alpha_cumprod: float


class DDIMScheduler:
    def __init__(self, config: DDIMConfig = DDIMConfig()):
        self.config = config
        T = config.num_train_timesteps
        if config.beta_schedule == "scaled_linear":
            betas = np.linspace(config.beta_start ** 0.5, config.beta_end ** 0.5,
                                T, dtype=np.float64) ** 2
        elif config.beta_schedule == "linear":
            betas = np.linspace(config.beta_start, config.beta_end, T, dtype=np.float64)
        else:
            raise ValueError(f"unsupported beta_schedule {config.beta_schedule}")
        self.betas = betas
        self.alphas_cumprod = np.cumprod(1.0 - betas)
        self.final_alpha_cumprod = (1.0 if config.set_alpha_to_one
                                    else float(self.alphas_cumprod[0]))

    # -- schedule construction (host-side) ---------------------------------

    def set_timesteps(self, num_inference_steps: int) -> DDIMState:
        cfg = self.config
        T = cfg.num_train_timesteps
        if cfg.timestep_spacing == "leading":
            step_ratio = T // num_inference_steps
            timesteps = (np.arange(0, num_inference_steps) * step_ratio).round()
            timesteps = timesteps[::-1].copy().astype(np.int64) + cfg.steps_offset
        elif cfg.timestep_spacing == "trailing":
            step_ratio = T / num_inference_steps
            timesteps = np.round(np.arange(T, 0, -step_ratio)).astype(np.int64) - 1
        else:
            raise ValueError(f"unsupported timestep_spacing {cfg.timestep_spacing}")
        return DDIMState(config=cfg, num_inference_steps=num_inference_steps,
                         timesteps=timesteps, betas=self.betas,
                         alphas_cumprod=self.alphas_cumprod,
                         final_alpha_cumprod=self.final_alpha_cumprod)

    # -- per-step coefficients (host-side floats) --------------------------

    def step_coeffs(self, state: DDIMState, step_index: int):
        """(sqrt_a_t, sqrt_1m_a_t, sqrt_a_prev, sqrt_1m_a_prev) for step i."""
        # clamp: steps_offset=1 can push the first timestep to T at
        # num_inference_steps == T (latent diffusers bug; we clamp instead)
        t = min(int(state.timesteps[step_index]), state.config.num_train_timesteps - 1)
        prev_t = t - state.config.num_train_timesteps // state.num_inference_steps
        a_t = float(state.alphas_cumprod[t])
        a_prev = float(state.alphas_cumprod[prev_t]) if prev_t >= 0 else state.final_alpha_cumprod
        return (a_t ** 0.5, (1.0 - a_t) ** 0.5, a_prev ** 0.5, (1.0 - a_prev) ** 0.5)

    def coeff_tables(self, state: DDIMState) -> np.ndarray:
        """(n, 4) float32 table of step_coeffs for every step."""
        return np.asarray([self.step_coeffs(state, i)
                           for i in range(state.num_inference_steps)], dtype=np.float32)

    # -- pure ops -----------------------------------------------------------

    @staticmethod
    def scale_model_input(sample, t=None):
        """The identity: DDIM does not scale the model's input."""
        return sample

    @staticmethod
    def step_from_coeffs(model_output, sample, coeffs):
        """DDIM update from precomputed coefficients.

        coeffs: 4 floats (or a length-4 array)
        returns (prev_sample, pred_original_sample)
        """
        sa_t, s1a_t, sa_p, s1a_p = (float(c) for c in coeffs)
        x0 = (sample - s1a_t * model_output) / sa_t
        prev = sa_p * x0 + s1a_p * model_output
        return prev, x0

    def step(self, state: DDIMState, model_output, step_index: int, sample):
        """The update at a Python step index, computed in fp32; returns
        (prev_sample, pred_original_sample) in the sample's dtype."""
        prev, x0 = self.step_from_coeffs(model_output.float(), sample.float(),
                                         self.step_coeffs(state, step_index))
        return prev.to(sample.dtype), x0.to(sample.dtype)

    def add_noise(self, original_samples, noise, t: int):
        """sqrt(a_t) * x0 + sqrt(1 - a_t) * eps."""
        a, b = self.add_noise_coeffs(t)
        return a * original_samples + b * noise

    def add_noise_coeffs(self, t: int):
        a_t = float(self.alphas_cumprod[int(t)])
        return a_t ** 0.5, (1.0 - a_t) ** 0.5

    # -- repaint / undo -----------------------------------------------------

    def undo_step_coeffs(self, state: DDIMState, timestep: int):
        """Coefficients for the repaint re-noise: n = T//num_inference_steps
        micro-steps, each  x <- sqrt(1-beta_{t+i}) x + sqrt(beta_{t+i}) eps_i.

        Returns (sqrt_1m_betas, sqrt_betas): two (n,) float32 arrays.
        """
        n = state.config.num_train_timesteps // state.num_inference_steps
        ts = [int(timestep) + i for i in range(n)
              if int(timestep) + i < state.config.num_train_timesteps]
        b = self.betas[np.asarray(ts, dtype=np.int64)]
        return (np.sqrt(1.0 - b).astype(np.float32), np.sqrt(b).astype(np.float32))

    @staticmethod
    def undo_step_from_coeffs(sample, noises, sqrt_1m_betas, sqrt_betas):
        """The repaint micro-steps with given noises, one per micro-step in
        order: x <- sqrt_1m_betas[i] x + sqrt_betas[i] noises[i]. `noises` is
        iterated, so it may draw each noise as its micro-step is reached."""
        noises = iter(noises)
        x = sample
        for s1mb, sb in zip(sqrt_1m_betas, sqrt_betas):
            x = float(s1mb) * x + float(sb) * next(noises)
        return x
