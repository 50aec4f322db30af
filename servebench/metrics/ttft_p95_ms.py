"""ttft_p95_ms: 95th percentile over every request due in the window of due time to first token; a failed request's is infinite."""
from servebench.readers import ttft_p95_ms as read

__all__ = ["read"]
