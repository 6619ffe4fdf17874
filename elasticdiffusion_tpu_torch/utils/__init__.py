"""Utilities: the CLIP tokenizer and image assembly helpers."""
