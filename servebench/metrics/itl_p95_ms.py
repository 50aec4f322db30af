"""itl_p95_ms: 95th percentile of every gap between consecutive output tokens of the window's requests, pooled."""
from servebench.readers import itl_p95_ms as read

__all__ = ["read"]
