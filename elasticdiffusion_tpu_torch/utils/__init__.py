"""Utilities: the CLIP tokenizer, image assembly helpers, wall-clock
timing (``timeit``) and the analytic cost model (``flops``)."""
