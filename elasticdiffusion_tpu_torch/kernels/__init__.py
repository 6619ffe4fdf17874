"""Hand-written Hopper kernels and their plain PyTorch versions.

Each module holds one kernel's wrapper, its plain version, a launch count
and the dispatch on ``use_kernels``:

  'auto'  kernel for a CUDA tensor, plain version for a CPU tensor
  'on'    kernel; a CPU tensor raises
  'off'   plain version everywhere (comparisons only)
"""

MODES = ("auto", "on", "off")


def wants_kernel(mode: str, is_cuda: bool, what: str) -> bool:
    """Resolve ``use_kernels`` for one tensor. No fallback: a CUDA tensor
    under 'auto' or 'on' always means the kernel."""
    if mode not in MODES:
        raise ValueError(f"use_kernels must be one of {MODES}, got {mode!r}")
    if mode == "off":
        return False
    if mode == "on" and not is_cuda:
        raise RuntimeError(f"{what}: use_kernels='on' needs a CUDA tensor")
    return is_cuda


# Optional per-shape record of launches: set to a collections.Counter to
# learn which shapes a run sent to which kernel; None costs nothing.
launch_log = None


def note_launch(name: str, *key) -> None:
    if launch_log is not None:
        launch_log[(name,) + key] += 1
