"""Layers of the port, one module per JAX layer module."""
