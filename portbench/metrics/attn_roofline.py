"""attn_roofline: the UNet attention's share of its roofline, in %: the
least time of the window's UNet attention calls on one H100 (per call the
larger of its operations over the rate and its bytes over 3.35 TB/s, calls
and shapes from the frozen cost model; in bfloat16 2-byte elements at 989
TFLOP/s, in float32 4-byte elements at the 3xTF32 floor, three passes at
494.7 TFLOP/s; a ControlNet's calls counted beside the UNet's) over the
device time of the kernels that ran them in the traced window. The kernels
are those whose name matches a pattern of a file in
``attn_roofline.patterns/``: the bf16 and the fp32 UNet bodies."""

from pathlib import Path

PATTERNS = Path(__file__).resolve().parent / "attn_roofline.patterns"


def patterns():
    out = []
    for f in sorted(PATTERNS.iterdir()):
        out += [ln.strip() for ln in f.read_text().splitlines()
                if ln.strip() and not ln.lstrip().startswith("#")]
    return out


def read(run):
    if run.trace is None or run.costs["attn_bound_s"] <= 0:
        return None
    measured = run.trace.kernel_seconds(patterns())
    if measured <= 0:
        return None
    return 100.0 * run.traced_images * run.costs["attn_bound_s"] / measured
