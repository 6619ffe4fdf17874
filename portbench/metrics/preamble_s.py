"""preamble_s: the mean over the window's images of the program's
``last_metrics["preamble_seconds"]``: ``_context`` and ``_schedule`` (text
encoders, view and resample plans, background tables), up to a
synchronisation before the first step."""


def read(run):
    vals = [img["metrics"].get("preamble_seconds") for img in run.images]
    return sum(vals) / len(vals) if None not in vals else None
