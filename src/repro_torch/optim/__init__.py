"""Optimizer of the port: AdamW with int8 moments and int8 gradient compression."""
