"""Decoding at sizes past one monolithic pass: ``halo_decode``. One GPU; the
JAX package's multi-chip branch (bands sharded over a mesh) waits for the
multi-GPU port (ROADMAP.md Queue 1)."""
