"""The benchmark's own tests (gpubench/tests/conftest.py)."""
