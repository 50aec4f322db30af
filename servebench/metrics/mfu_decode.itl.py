"""mfu_decode.itl: Model FLOPs of the active slots' decode tokens over the decode steps' wall at the bf16 peak."""
from servebench.readers import mfu_decode as read

__all__ = ["read"]
