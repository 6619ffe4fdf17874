"""Utilities: the CLIP tokenizer, image assembly helpers and wall-clock
timing (``timeit``)."""
