"""setup_s: Process start to window start: imports, weights, kernels, captures, warm-up."""
from servebench.readers import setup_s as read

__all__ = ["read"]
