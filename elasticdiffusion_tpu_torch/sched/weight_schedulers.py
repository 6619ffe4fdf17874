"""RRG weight schedulers.

  - CosineScheduler(steps, cosine_scale, factor): 0 for t >= steps, else
    factor * (0.5*(1+cos(pi*t/steps)))**cosine_scale
  - LinearScheduler(steps, start_val, stop_val): stop_val for t >= steps,
    else linear ramp start->stop
  - ConstScheduler(steps, start_val, stop_val): stop_val for t >= steps,
    else start_val

Host-side numpy: the weights are baked per step into a table. The class API
(callable on the step index) is kept because ``rrg_scherduler_cls`` is a
public argument of ``generate_image``.
"""

from __future__ import annotations

from typing import Any

import numpy as np


class LinearScheduler:
    def __init__(self, steps, start_val, stop_val):
        self.steps = steps
        self.start_val = start_val
        self.stop_val = stop_val

    def __call__(self, t, *args: Any, **kwds: Any):
        if t >= self.steps:
            return self.stop_val
        return self.start_val + (self.stop_val - self.start_val) / self.steps * t


class ConstScheduler:
    def __init__(self, steps, start_val, stop_val):
        self.steps = steps
        self.start_val = start_val
        self.stop_val = stop_val

    def __call__(self, t, *args: Any, **kwds: Any):
        if t >= self.steps:
            return self.stop_val
        return self.start_val


class CosineScheduler:
    def __init__(self, steps, cosine_scale, factor=0.01):
        self.steps = steps
        self.cosine_scale = cosine_scale
        self.factor = factor

    def __call__(self, t, *args: Any, **kwds: Any):
        if t >= self.steps:
            return 0
        cosine_factor = 0.5 * (1 + np.cos(np.pi * t / self.steps))
        return self.factor * (cosine_factor ** self.cosine_scale)


def make_rrg_scheduler(name_or_cls, num_inference_steps: int, rrg_stop_t: float,
                       rrg_init_weight: float, cosine_scale: float):
    """Build the RRG scheduler exactly as the pipeline does: active for
    steps = N - int(N * rrg_stop_t); cosine gets (cosine_scale, factor),
    others get (start_val=init, stop_val=0)."""
    steps = num_inference_steps - int(num_inference_steps * rrg_stop_t)
    if isinstance(name_or_cls, str):
        cls = {"cosine": CosineScheduler, "linear": LinearScheduler,
               "const": ConstScheduler}[name_or_cls]
    else:
        cls = name_or_cls
    if cls is CosineScheduler:
        return cls(steps=steps, cosine_scale=cosine_scale, factor=rrg_init_weight)
    return cls(steps=steps, start_val=rrg_init_weight, stop_val=0)


def rrg_weight_table(scheduler, num_inference_steps: int) -> np.ndarray:
    """Per-step RRG weights as a float32 array."""
    return np.asarray([float(scheduler(i)) for i in range(num_inference_steps)],
                      dtype=np.float32)
