"""Planar math, RNG and host color fits of the port."""
