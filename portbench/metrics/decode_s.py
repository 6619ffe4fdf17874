"""decode_s: the mean over the window's images of the program's
``last_metrics["decode_seconds"]`` (synchronised): ``decode_latents``, or
``halo_decode`` with the tiled decoder."""


def read(run):
    vals = [img["metrics"].get("decode_seconds") for img in run.images]
    return sum(vals) / len(vals) if None not in vals else None
