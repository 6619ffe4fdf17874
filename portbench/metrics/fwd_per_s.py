"""fwd_per_s: UNet rows a second in the denoise loop, the program's
``unet_view_forwards`` over its ``denoise_seconds`` (synchronised), summed
over the window's images. Read only where the program's count agrees with
the benchmark's own, 2(rs+1) + V a step and 2 + V more with repaint."""


def read(run):
    fwd = [img["metrics"].get("unet_view_forwards") for img in run.images]
    if any(f != run.costs["unet_rows"] for f in fwd):
        return None
    return sum(fwd) / sum(img["metrics"]["denoise_seconds"] for img in run.images)
