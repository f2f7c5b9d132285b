"""The benchmark's own tests: `python -m pytest gpubench/tests -q`. Tests
marked `card` need a CUDA device and skip without one; they decide so in
a fixture, never while the module is imported."""
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "card: needs a CUDA device (skips without one)")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the benchmark's card runs need one")
    return torch.device("cuda", 0)


def tiny(traffic: dict) -> dict:
    """A cell's traffic at a size the CPU renders in a second."""
    t = dict(traffic)
    t.update(width=16, height=16, spp=4, spp_per_pass=4, warmup_frames=1)
    if "check" in t:
        t["check"] = dict(t["check"], pixels=64)
    return t
