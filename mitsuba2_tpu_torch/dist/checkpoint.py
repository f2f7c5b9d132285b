"""Checkpoint and resume for long renders and optimizations (counterpart
of dist/checkpoint.py).

A state (nested dicts, lists and tuples of tensors: a film and its
weight, a scene's diff tables, Adam's moments) is saved as an .npz of
its leaves, `leaf_0` ... `leaf_{n-1}`, and `__meta__`, a JSON of the
step, the caller's meta and the state's structure. The leaves are in
the JAX package's order (a dict's keys sorted, lists and tuples in
order) and the file is the JAX package's layout, so a checkpoint either
package writes loads in the other as the same list of leaves. The file
is written to a temporary name and renamed over the old one, so a crash
never leaves half a checkpoint.
"""
from __future__ import annotations

import json
import os
import tempfile
from typing import Any, Tuple

import numpy as np
import torch

from ..device import resolve_device


def _flatten(tree, leaves):
    """Append `tree`'s leaves to `leaves` in the JAX package's order;
    returns the structure (a JSON-able description)."""
    if isinstance(tree, dict):
        keys = sorted(tree)
        return {"dict": [[k, _flatten(tree[k], leaves)] for k in keys]}
    if isinstance(tree, (list, tuple)):
        kind = "list" if isinstance(tree, list) else "tuple"
        return {kind: [_flatten(v, leaves) for v in tree]}
    if tree is None:
        return {"none": 0}
    leaves.append(tree)
    return {"leaf": len(leaves) - 1}


def _unflatten(structure, leaves):
    (kind, body), = structure.items()
    if kind == "dict":
        return {k: _unflatten(v, leaves) for k, v in body}
    if kind in ("list", "tuple"):
        out = [_unflatten(v, leaves) for v in body]
        return out if kind == "list" else tuple(out)
    if kind == "none":
        return None
    return leaves[body]


def _numpy(x):
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def save(path: str, state: Any, step: int = 0, meta: dict = None) -> None:
    """Snapshot `state` (with `step` and a JSON-able `meta`) at `path`,
    atomically."""
    leaves = []
    structure = _flatten(state, leaves)
    payload = {f"leaf_{i}": _numpy(x) for i, x in enumerate(leaves)}
    payload["__meta__"] = np.frombuffer(json.dumps(
        {"step": step, "structure": structure, "meta": meta or {}}).encode(),
        np.uint8)
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    os.close(fd)
    try:
        with open(tmp, "wb") as f:
            np.savez(f, **payload)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _tensor(a: np.ndarray, dev):
    # uint32 values live in int64 tensors, as everywhere in the port
    if a.dtype == np.uint32:
        a = a.astype(np.int64)
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


def load(path: str, like: Any = None, device=None) -> Tuple[Any, int, dict]:
    """Load a snapshot onto `device` (None = the CUDA device; raises
    without one). With `like` (a state of the same structure) the leaves
    are put back into that structure; without it they come as a list.
    Returns (state, step, meta)."""
    dev = resolve_device(device)
    with np.load(path) as z:
        meta = json.loads(bytes(z["__meta__"]).decode())
        n = len([k for k in z.files if k.startswith("leaf_")])
        leaves = [_tensor(z[f"leaf_{i}"], dev) for i in range(n)]
    if like is None:
        return leaves, meta["step"], meta["meta"]
    like_leaves = []
    structure = _flatten(like, like_leaves)
    if len(like_leaves) != n:
        raise ValueError(f"{path} holds {n} leaves, `like` "
                         f"{len(like_leaves)}")
    return _unflatten(structure, leaves), meta["step"], meta["meta"]


class CheckpointedRender:
    """A restartable render of many passes: it sums each pass's image
    and weight and saves (image, weight) with the passes done every
    `every` passes:

        ck = CheckpointedRender("film.npz", every=8)
        start = ck.resume()            # 0 on a fresh run
        for p in range(start, n_passes):
            img_p, w_p = render_pass(scene, config, pass_seeds(seed, n_passes)[p])
            ck.update(img_p, w_p, p)
        image = ck.develop()
    """

    def __init__(self, path: str, every: int = 8, device=None):
        self.path = path
        self.every = every
        self.device = device
        self.image = None
        self.wsum = None
        self.done = 0

    def resume(self) -> int:
        """Load the snapshot where there is one; returns the passes done."""
        if os.path.exists(self.path):
            state, step, _ = load(self.path, device=self.device)
            self.image, self.wsum = state[0], state[1]
            self.done = step
        return self.done

    def update(self, img_p, w_p, pass_idx: int) -> None:
        self.image = img_p if self.image is None else self.image + img_p
        self.wsum = w_p if self.wsum is None else self.wsum + w_p
        self.done = pass_idx + 1
        if self.done % self.every == 0:
            save(self.path, [self.image, self.wsum], step=self.done)

    def develop(self):
        from ..render import film as film_mod
        save(self.path, [self.image, self.wsum], step=self.done)
        return film_mod.develop(self.image, self.wsum)
