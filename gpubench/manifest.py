"""Find the benchmark's files by the names BENCHMARK.json gives: a cell's
configuration (configs/<config>.json) and traffic (traffic/<traffic>.json),
its entry (entries/<entry>.py), the scene generator a configuration names
(scenes/<scene>.py) and each per-layer metric's reader
(metrics/<metric>.py, or for a metric `<family>.<variant>` without a
file of its own, metrics/<family>.py). Adding a cell, a configuration or
a metric adds files; no file here changes."""
from __future__ import annotations

import importlib
import importlib.util
import json
import os
import re

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
# a metric variant that names an entry is read only in that entry's cells
VARIANT_ENTRY = {"render": "render", "grad": "grad_step"}


def _name(kind: str, name: str) -> str:
    if not isinstance(name, str) or not NAME.match(name):
        raise ValueError(f"bad {kind} name {name!r}")
    return name


def _json(*parts) -> dict:
    with open(os.path.join(HERE, *parts)) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no cell {name!r} in BENCHMARK.json")


def config(name: str) -> dict:
    return _json("configs", _name("config", name) + ".json")


def traffic(name: str) -> dict:
    return _json("traffic", _name("traffic", name) + ".json")


def scene_spec(cfg: dict) -> dict:
    """The configuration's scene, made by its generator from its args."""
    mod = importlib.import_module("gpubench.scenes."
                                  + _name("scene", cfg["scene"]))
    return mod.build(**cfg.get("args", {}))


def entry(name: str):
    return importlib.import_module("gpubench.entries." + _name("entry", name))


def _reader(stem: str):
    path = os.path.join(HERE, "metrics", stem + ".py")
    spec = importlib.util.spec_from_file_location(
        "gpubench_metric_" + stem.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def metric_reader(name: str):
    """`read(ctx) -> float | None` of metrics/<name>.py; else, for a
    name `<family>.<variant>`, metrics/<family>.py's, which reads
    nothing in a cell whose entry the variant does not name
    (VARIANT_ENTRY)."""
    _name("metric", name)
    if os.path.exists(os.path.join(HERE, "metrics", name + ".py")):
        return _reader(name)
    family, _, variant = name.rpartition(".")
    if not family:
        raise FileNotFoundError(f"no reader metrics/{name}.py")
    read, entry = _reader(family), VARIANT_ENTRY.get(variant)
    return lambda ctx: (read(ctx) if entry in (None, ctx.entry) else None)


def cell_metrics(bench: dict, cell_name: str):
    """(end-to-end metrics, per-layer metrics) that the cell reports: an
    end-to-end metric where its `workloads` name the cell or it has none;
    a per-layer metric where its `workloads` name the cell, or, without
    the key, where the cell reports the end-to-end metric it moves."""
    e2e = [m for m in bench["end_to_end"]
           if cell_name in m.get("workloads", [cell_name])]
    names = {m["name"] for m in e2e}
    per = [m for m in bench["per_layer"]
           if (cell_name in m["workloads"] if "workloads" in m
               else m["moves"] in names)]
    return e2e, per
