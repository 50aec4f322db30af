"""decode_tick_ms.ttft: Mean wall of one replica's decode step (Replica.tick_times) in the window."""
from servebench.readers import decode_tick_ms as read

__all__ = ["read"]
