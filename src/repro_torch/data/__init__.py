"""Data pipeline of the port: the step-indexed synthetic token stream."""
