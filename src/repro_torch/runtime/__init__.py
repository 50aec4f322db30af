"""Serving and training runtimes of the port."""
