"""cn_row_ms: milliseconds of ControlNet a batch row: the program's
``controlnet_device_seconds`` (each ``apply_controlnet`` call's stream
time, between CUDA events recorded just before and just after it) over its
``controlnet_view_forwards``, summed over the window's images. Read only
where every image's count is the benchmark's own count of rows (a
ControlNet row beside each UNet row); None where the images carry no
ControlNet counter."""


def read(run):
    imgs = [img["metrics"] for img in run.images]
    if any(m.get("controlnet_view_forwards") != run.costs["unet_rows"] for m in imgs):
        return None
    return 1000.0 * sum(m["controlnet_device_seconds"] for m in imgs) / sum(
        m["controlnet_view_forwards"] for m in imgs)
