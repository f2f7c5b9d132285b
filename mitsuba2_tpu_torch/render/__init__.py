"""Sampling, shading, film and the path tracer of the port."""
