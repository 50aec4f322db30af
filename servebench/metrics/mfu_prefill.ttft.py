"""mfu_prefill.ttft: Model FLOPs of the window's prefills over their wall (Replica.prefill_times) at the bf16 peak."""
from servebench.readers import mfu_prefill as read

__all__ = ["read"]
