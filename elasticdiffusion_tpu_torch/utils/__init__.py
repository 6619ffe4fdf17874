"""Utilities: the CLIP tokenizer, image assembly helpers, wall-clock
timing (``timeit``), the spans of ``generate_image`` (``trace``) and the
analytic cost model (``flops``)."""
