"""output_tokens_per_s: Output tokens completed in the window over the window's seconds."""
from servebench.readers import output_tokens_per_s as read

__all__ = ["read"]
