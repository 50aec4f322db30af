"""device_idle_share.itl: Share of the profiled slice in which no device operation ran."""
from servebench.readers import device_idle_share as read

__all__ = ["read"]
