"""mfu_pct: the whole step's share of the H100's bf16 peak, in %: the model
FLOPs of the measured window's images (UNet rows at the native latent, with
a ControlNet row beside each where the configuration has one, and one VAE
decode an image, counted by the frozen cost model; the text encoders and
the background encodes left out; fp32 work, a whole fp32 configuration's
too, counted against the bf16 peak) over the window's seconds x 989
TFLOP/s. Read in the traced run, from its untraced window."""

from portbench.costmodel import BF16_FLOPS


def read(run):
    return 100.0 * len(run.images) * run.costs["flops"] / (run.window_s * BF16_FLOPS)
