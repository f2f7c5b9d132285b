"""The differentiable-parameter map: mitsuba's `traverse()` and
ParameterMap (counterpart of mitsuba2_tpu/diff/params.py).

`traverse` exposes named views into the packed tables, recorded at build
time in `SceneData.param_paths`. Updates are functional: `scene_with` and
`ParameterMap.update` return a new SceneData (dataclasses.replace) with
new tables and never write into the old ones. `scene_with` is
differentiable with respect to the values: an RGB slot is rebuilt on the
device through the coefficient lattice, as the JAX package rebuilds it,
and a texture's texels ("image" entries, `textures.data`) rebuild the
atlas' mip pyramid.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Dict

import torch

from ..core import spectrum as sp


def _slot_update(row_slice, rgb):
    """A full 8-wide spectrum slot from a new RGB value, differentiably:
    the coefficients from the lattice, out-of-gamut brightness folded
    into the scale column, the kind column kept (render/spectra.py)."""
    rgb = torch.as_tensor(rgb, dtype=torch.float32,
                          device=row_slice.device).reshape(3)
    scale = torch.maximum(torch.max(rgb) / 0.999, rgb.new_tensor(1.0))
    coeffs = sp.srgb_model_fetch_interp(sp.srgb_model_fetch_lattice(),
                                        rgb / scale)
    return torch.cat([rgb, coeffs, scale[None], row_slice[7:8]])


def _get_table(scene, table: str):
    obj = scene
    for part in table.split("."):
        obj = getattr(obj, part)
    return obj


def _set_table(scene, table: str, value):
    """The scene with `table` replaced: a table of SceneData, or the
    atlas' texels ("textures.data"), whose pyramid is rebuilt from them
    (parameters_changed())."""
    if table == "textures.data":
        return dataclasses.replace(scene,
                                   textures=scene.textures.with_data(value))
    return dataclasses.replace(scene, **{table: value})


class ParameterMap:
    """Flat name -> parameter view over a scene."""

    def __init__(self, scene, entries=None):
        self.scene = scene
        if entries is None:
            entries = {p[0]: p[1:] for p in scene.param_paths}
        self._entries = dict(entries)

    def keys(self):
        return self._entries.keys()

    def items(self):
        return ((k, self[k]) for k in self._entries)

    def __len__(self):
        return len(self._entries)

    def __contains__(self, name):
        return name in self._entries

    def __iter__(self):
        return iter(self._entries)

    def __getitem__(self, name) -> torch.Tensor:
        table, row, c0, c1, kind = self._entries[name]
        arr = _get_table(self.scene, table)
        if kind == "image":
            return arr[row]
        return arr[row, c0:c1] if c1 - c0 > 1 else arr[row, c0]

    def keep(self, patterns) -> "ParameterMap":
        """Filter to names matching any regex (util.py::ParameterMap.keep)."""
        if isinstance(patterns, str):
            patterns = [patterns]
        kept = {k: v for k, v in self._entries.items()
                if any(re.search(p, k) for p in patterns)}
        return ParameterMap(self.scene, kept)

    def flat(self) -> Dict[str, torch.Tensor]:
        """{name: value}: the optimizable dict."""
        return {k: self[k] for k in self._entries}

    def update(self, values: Dict[str, torch.Tensor]) -> "ParameterMap":
        """A new ParameterMap over a scene with `values` applied (the
        functional analog of params.update())."""
        return ParameterMap(scene_with(self.scene, values, self._entries),
                            self._entries)


def traverse(scene) -> ParameterMap:
    """mitsuba.python.util.traverse: scene -> flat parameter map."""
    return ParameterMap(scene)


def scene_with(scene, values: Dict[str, torch.Tensor], entries=None):
    """A new scene with {name: value} applied onto its tables,
    differentiable with respect to the values: an "rgb" entry rebuilds its
    whole spectrum slot (_slot_update), a "scalar" one writes its column,
    an "image" one a texture's (TH, TW, 3) texels."""
    if entries is None:
        entries = {p[0]: p[1:] for p in scene.param_paths}
    # group updates by table so each table is copied once
    by_table: Dict[str, list] = {}
    for name, value in values.items():
        table, row, c0, c1, kind = entries[name]
        by_table.setdefault(table, []).append((row, c0, c1, kind, value))
    for table, ups in by_table.items():
        arr = _get_table(scene, table).clone()
        for row, c0, c1, kind, value in ups:
            value = torch.as_tensor(value, dtype=torch.float32,
                                    device=arr.device)
            if kind == "image":
                arr[row] = value.reshape(arr.shape[1:])
            elif kind == "rgb":
                arr[row, c0:c0 + 8] = _slot_update(arr[row, c0:c0 + 8],
                                                   value)
            else:
                arr[row, c0:c1] = value.reshape(c1 - c0)
        scene = _set_table(scene, table, arr)
    return scene
