"""What the host did while an image ran, printed beside its wall time so
that a spread of the host-clock metrics can be traced to its cause: the
main thread's CPU seconds, the seconds Python's garbage collector took, the
thread's voluntary and involuntary context switches, and the machine's
steal time (``/proc/stat``: seconds its CPUs waited for the hypervisor,
summed over them)."""

from __future__ import annotations

import gc
import os
import resource
import time
from typing import Dict

_gc = {"s": 0.0, "t": None}


def _on_gc(phase, info):
    if phase == "start":
        _gc["t"] = time.perf_counter()
    elif _gc["t"] is not None:
        _gc["s"] += time.perf_counter() - _gc["t"]
        _gc["t"] = None


def _steal_s() -> float:
    try:
        with open("/proc/stat") as f:
            fields = f.readline().split()
        return int(fields[8]) / os.sysconf("SC_CLK_TCK")
    except (OSError, IndexError, ValueError):
        return float("nan")


class Probe:
    """Started at an image's start; ``read()`` at its end."""

    def __init__(self):
        if _on_gc not in gc.callbacks:
            gc.callbacks.append(_on_gc)
        self._start = self._now()

    @staticmethod
    def _now() -> Dict[str, float]:
        ru = resource.getrusage(resource.RUSAGE_THREAD)
        return {"thread_cpu_s": time.thread_time(), "gc_s": _gc["s"],
                "ctx_vol": ru.ru_nvcsw, "ctx_invol": ru.ru_nivcsw,
                "steal_s": _steal_s()}

    def read(self) -> Dict[str, float]:
        end = self._now()
        return {k: end[k] - self._start[k] for k in end}
