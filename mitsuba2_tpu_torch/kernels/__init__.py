"""Traversal: brute force, the presort key and the CUDA walks."""
