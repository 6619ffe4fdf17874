"""Hand-written Hopper kernels and their plain PyTorch versions.

Each module holds one kernel's wrapper, its plain version, a launch count
and the dispatch on ``use_kernels``; ``wrappers`` lists the wrappers. The
launch counts (``<wrapper>.launches``) and ``launch_log`` count calls of the
Python wrappers. A UNet forward replayed from a CUDA graph
(``models/unet_graphs.py``) calls none, and adds what its capture counted:
the counts are the kernels that ran.

  'auto'  kernel for a CUDA tensor, plain version for a CPU tensor
  'on'    kernel; a CPU tensor raises
  'off'   plain version everywhere (comparisons only)

The 3x3 convolution is a configuration of its own, ``conv_impl``, as it is in
the JAX package (``ED_CONV_IMPL``):

  'cudnn'   the library convolution, ``models.layers.conv2d`` (the default)
  'kernel'  the hand-written kernel for a CUDA tensor inside its gate, its
            plain version for a CPU tensor
"""

MODES = ("auto", "on", "off")
CONV_IMPLS = ("cudnn", "kernel")


def check_conv_impl(mode: str) -> str:
    if mode not in CONV_IMPLS:
        raise ValueError(f"conv_impl must be one of {CONV_IMPLS}, got {mode!r}")
    return mode


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
# learn which shapes a run sent to which kernel; None costs nothing. A CUDA
# graph's replay adds the entries its capture recorded.
launch_log = None


def note_launch(name: str, *key) -> None:
    if launch_log is not None:
        launch_log[(name,) + key] += 1


def wrappers() -> dict:
    """Every kernel wrapper by name, each with its ``launches`` count; the
    GroupNorm kernel's two halves launch only in a streamed decode."""
    from .conv3x3 import conv3x3
    from .flash_attention import flash_attention
    from .groupnorm import fused_group_norm, group_norm_apply, group_norm_sums
    from .layernorm import fused_layer_norm
    return {"flash_attention": flash_attention,
            "fused_layer_norm": fused_layer_norm,
            "fused_group_norm": fused_group_norm, "conv3x3": conv3x3,
            "group_norm_sums": group_norm_sums,
            "group_norm_apply": group_norm_apply}
