"""Wall-clock timing of functions and blocks: ``TimeIt`` and ``timelog``.

Counterpart of ``elasticdiffusion_tpu/utils/timeit.py``. Each decorated
function or timed block adds its host seconds to a total per name. With
``sync=True`` the device is synchronised before the clock starts and before
it stops (``torch.cuda.synchronize`` on the device of the first CUDA tensor
among the function's results, else on the current device), so that the
time includes the work the call queued; with the default ``sync=False`` it
is the host's time to run the call, which on the GPU may end before the
device does.
"""

from __future__ import annotations

import contextlib
import functools
import time
from typing import Dict

import torch


def _cuda_device(value):
    """The device of the first CUDA tensor in a result (tensors, or tuples,
    lists and dicts of them), or None."""
    if torch.is_tensor(value):
        return value.device if value.is_cuda else None
    items = value.values() if isinstance(value, dict) else (
        value if isinstance(value, (list, tuple)) else ())
    for v in items:
        dev = _cuda_device(v)
        if dev is not None:
            return dev
    return None


class TimeIt:
    def __init__(self, sync: bool = False):
        self.sync = sync
        self.total_time: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    def _sync(self, value=None):
        if not self.sync:
            return
        dev = _cuda_device(value)
        if dev is not None:
            torch.cuda.synchronize(dev)
        elif torch.cuda.is_initialized():
            torch.cuda.synchronize()

    def _add(self, name: str, seconds: float):
        self.total_time[name] = self.total_time.get(name, 0.0) + seconds
        self.counts[name] = self.counts.get(name, 0) + 1

    def time_function(self, func):
        @functools.wraps(func)
        def wrapper(*args, **kwargs):
            self._sync()
            start = time.time()
            result = func(*args, **kwargs)
            self._sync(result)
            self._add(f"FUNCTION_{func.__name__}", time.time() - start)
            return result
        return wrapper

    @contextlib.contextmanager
    def time_block(self, title: str):
        self._sync()
        start = time.time()
        try:
            yield
        finally:
            self._sync()
            self._add(f"BLOCK_{title}", time.time() - start)

    def print_results(self):
        for key, spent in self.total_time.items():
            print(f"{key} took total {spent:.3f} seconds "
                  f"({self.counts.get(key, 0)} calls).")


timelog = TimeIt(sync=False)
