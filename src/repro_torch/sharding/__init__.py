"""Sharding of the port: partition specs and the activation context."""
