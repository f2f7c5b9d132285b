"""The JAX package's references for the port's tests, recorded once.

A test asks `Refs("name").get(key, fn)` for a reference: the value
stored under `key` in tests/goldens/name.npz, where `fn()` (a JAX call
returning numpy arrays, numbers, or tuples, lists and dicts of them)
would compute it. The JAX package jit-compiles and interprets Pallas
kernels for minutes on a CPU, so the tests read the file; its script

    python tests/goldens/make_refs.py name

runs the test file with the recorder on: every `get` then calls its
`fn`, and the file is written when the run ends. `fresh(key, fn)`
recomputes one entry live, so that a stale file fails its test.
"""
from __future__ import annotations

import atexit
import json
import os

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
# the name of the file being recorded (make_refs.py sets it)
RECORD_ENV = "MI_RECORD_JAX_REFS"


def _flatten(key, value, out):
    """Store `value` under npz keys below `key`; returns its tree (a
    dict's keys become strings)."""
    if isinstance(value, dict):
        return {"d": {str(k): _flatten(f"{key}/{k}", v, out)
                      for k, v in value.items()}}
    if isinstance(value, (tuple, list)):
        return {"t": [_flatten(f"{key}/{i}", v, out)
                      for i, v in enumerate(value)]}
    if value is None:
        return {"n": 0}
    out[key] = np.asarray(value)
    return {"a": key, "s": int(np.ndim(value) == 0 and not isinstance(
        value, np.ndarray))}


def _unflatten(tree, data):
    if "d" in tree:
        return {k: _unflatten(v, data) for k, v in tree["d"].items()}
    if "t" in tree:
        return tuple(_unflatten(v, data) for v in tree["t"])
    if "n" in tree:
        return None
    a = data[tree["a"]]
    return a.item() if tree["s"] else a


class Refs:
    """The references of one test file (tests/goldens/<name>.npz)."""

    def __init__(self, name: str):
        self.name = name
        self.path = os.path.join(HERE, f"{name}.npz")
        self.recording = os.environ.get(RECORD_ENV) == name
        self.trees, self.data = {}, {}
        if self.recording:
            atexit.register(self.save)
        elif os.path.exists(self.path):
            with np.load(self.path) as f:
                self.data = {k: f[k] for k in f.files}
            self.trees = json.loads(str(self.data.pop("__trees__")))

    def get(self, key: str, fn=None):
        """The reference under `key`; recorded from fn() when recording
        (without `fn`, the entry another call recorded)."""
        if self.recording and fn is not None:
            value = fn()
            self.trees[key] = _flatten(key, value, self.data)
            return _unflatten(self.trees[key], self.data)
        if key not in self.trees:
            raise KeyError(
                f"{self.path} holds no {key!r}: run python "
                f"tests/goldens/make_refs.py {self.name}")
        return _unflatten(self.trees[key], self.data)

    def fresh(self, key: str, fn):
        """(stored, live): the stored reference and fn() computed now."""
        return self.get(key, fn), fn()

    def save(self):
        np.savez_compressed(self.path, __trees__=np.asarray(
            json.dumps(self.trees)), **self.data)
