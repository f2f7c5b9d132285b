"""Utilities of the port (counterpart of mitsuba2_tpu/utils/):
observability for long renders."""
