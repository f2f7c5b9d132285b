"""Device choice for the port's entry points.

The port runs on the card. An entry point given no device takes CUDA and
raises when there is none: it never carries on silently on the CPU. The
tests, and anyone else who wants the CPU, pass `device="cpu"`.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`None` -> the CUDA device (raises without one); else the device asked for."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "mitsuba2_tpu_torch runs on a CUDA device and none is "
                "available; pass device='cpu' to run on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device!r} asked for but CUDA is "
                               "not available")
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def device_name(device) -> str:
    """The name of `device` for a report line: the card's
    (torch.cuda.get_device_name), or "cpu"."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return torch.cuda.get_device_name(dev)
    return dev.type
