"""Checkpointing of the port: atomic, async, in the JAX package's on-disk layout."""
