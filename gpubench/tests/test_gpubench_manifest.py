"""BENCHMARK.json and the files it names: every configuration, traffic
mix and metric reader loads and is found by name, and names, units and
sizes keep to the benchmark's rules."""
import json
import os
import re

import pytest

from gpubench import manifest

BENCH = manifest.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT_MAX = 200


def _text(s):
    return isinstance(s, str) and 1 <= len(s) <= TEXT_MAX and \
        "\n" not in s and "\t" not in s


def test_top_level_keys_and_size():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    path = os.path.join(manifest.ROOT, "BENCHMARK.json")
    assert os.path.getsize(path) <= 64 * 1024
    assert BENCH["command"] == ["python3", "gpubench/run.py"]
    assert BENCH["paths"] == ["gpubench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert isinstance(BENCH["run_seconds"], int)


@pytest.mark.parametrize("c", BENCH["configs"], ids=lambda c: c["name"])
def test_config_loads(c):
    assert set(c) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(c["name"]) and _text(c["source"]) and _text(c["why"])
    assert c["file"] == f"gpubench/configs/{c['name']}.json"
    cfg = manifest.config(c["name"])
    assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
    assert all(NAME.match(k) for k in c["reduced"])
    spec = manifest.scene_spec(cfg)
    assert sum(len(s["faces"]) for s in spec["shapes"]) == cfg["prims"]
    assert sum(s["radiance"] is not None for s in spec["shapes"]) \
        == cfg["emitters"]
    assert any(w["config"] == c["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_loads(w):
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(w["name"]) and NAME.match(w["traffic"])
    assert w["chips"] in (1, 4) and _text(w["why"])
    assert w["config"] in {c["name"] for c in BENCH["configs"]}
    t = manifest.traffic(w["traffic"])
    assert t["why"] == w["why"]
    assert t["spp_per_pass"] == t["spp"]       # one pass a frame
    assert t["rr_depth"] >= t["max_depth"]     # no roulette drawn
    manifest.entry(t["entry"]).Entry           # found by name
    e2e, per = manifest.cell_metrics(BENCH, w["name"])
    names = [m["name"] for m in e2e]
    assert "setup_s" in names and len(names) >= 2 and per
    assert manifest.entry(t["entry"]).Entry.metric in names


def test_cells_unique_and_four_chip_share():
    cells = BENCH["workloads"]
    assert len({w["name"] for w in cells}) == len(cells)
    assert len({(w["config"], w["traffic"]) for w in cells}) == len(cells)
    assert sum(w["chips"] == 4 for w in cells) <= max(1, len(cells) // 4)


def test_end_to_end_metrics():
    names = [m["name"] for m in BENCH["end_to_end"]]
    assert "setup_s" in names and len(set(names)) == len(names)
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", cells)) <= cells


@pytest.mark.parametrize("m", BENCH["per_layer"], ids=lambda m: m["name"])
def test_per_layer_metric_reader_found(m):
    assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                      "layer", "moves"}
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher") and _text(m["layer"])
    assert m["source"] in ("device_trace", "program_span",
                           "program_counter", "host_clock")
    assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
    assert callable(manifest.metric_reader(m["name"]))
    for cell in m.get("workloads", []):
        e2e, _ = manifest.cell_metrics(BENCH, cell)
        assert m["moves"] in {e["name"] for e in e2e}
    if "roofline" in m["name"]:
        assert m["name"].endswith("_roofline") and m["unit"] == "%"


def test_files_under_paths_are_named_from_name_characters():
    for dirpath, dirs, files in os.walk(manifest.HERE):
        dirs[:] = [d for d in dirs if d != "__pycache__"]
        for f in files:
            rel = os.path.relpath(os.path.join(dirpath, f), manifest.ROOT)
            assert re.match(r"^[A-Za-z0-9_./-]{1,200}$", rel), rel


def test_traffic_and_config_files_are_json():
    for sub in ("configs", "traffic"):
        for f in os.listdir(os.path.join(manifest.HERE, sub)):
            with open(os.path.join(manifest.HERE, sub, f)) as fh:
                json.load(fh)
