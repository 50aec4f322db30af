"""route_us_per_request.tput: Host time in the tAPP router per invocation routed, its admit calls left out."""
from servebench.readers import route_us_per_request as read

__all__ = ["read"]
