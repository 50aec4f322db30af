"""Roofline of the port: per-device counts of a traced call against the H100's peaks."""
