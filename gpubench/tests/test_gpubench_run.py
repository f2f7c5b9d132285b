"""A run end to end on the CPU at 16 x 16 (the look for a CUDA device
skipped): the result line's keys, `correct` false under each fault the
cells can have, no JAX or JAX package loaded, the exit codes without a
card and without the program; and a run on the card, where there is
one."""
import json
import os
import shutil
import subprocess
import sys
import time
import types

import pytest

from gpubench import faults, manifest, run as run_mod
from gpubench.entries import common

from .conftest import ROOT, tiny

BENCH = manifest.benchmark()
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def _run(cell, trace=0, api=None, seed=2 ** 31 + 12345):
    import mitsuba2_tpu_torch as mt
    c = manifest.cell(BENCH, cell)
    return run_mod.run_cell(BENCH, c, seed, 0.2, trace, "cpu",
                            time.monotonic(),
                            traffic=tiny(manifest.traffic(c["traffic"])),
                            api=api or common.program_api(mt))


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_result_line_keys(cell):
    for trace in (0, 1):
        out = _run(cell, trace)
        keys = list(out)
        assert keys[:5] == KEYS and keys[-1] == "checks"
        assert set(keys) <= set(KEYS) | {"breakdown", "checks"}
        assert out["correct"] is True, out["checks"]
        assert {"platform", "kind", "count", "memory_peak_bytes"} \
            <= set(out["device"])
        e2e, per = manifest.cell_metrics(BENCH, cell)
        if trace:
            assert {"busy_s", "window_s"} <= set(out["device"])
            assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
            assert set(out["metrics"]) <= {m["name"] for m in per}
            assert "scene_build_s" in out["metrics"]
        else:
            assert set(out["metrics"]) == {m["name"] for m in e2e}
        for name, m in out["metrics"].items():
            assert set(m) == {"value", "unit"} and m["value"] > 0 \
                or name.startswith(("launches", "device_idle", "walk"))


@pytest.mark.parametrize("cell,fault", [
    (w["name"], f) for w in BENCH["workloads"]
    for f in faults.FAULTS[manifest.traffic(w["traffic"])["entry"]]])
def test_fault_reads_not_correct(cell, fault):
    import mitsuba2_tpu_torch as mt
    api = faults.FAULTS[manifest.traffic(
        manifest.cell(BENCH, cell)["traffic"])["entry"]][fault](
        common.program_api(mt))
    out = _run(cell, api=api)
    assert out["correct"] is False, out["checks"]


def _late(api, name, alter):
    """The program's entry point `name` with its output altered by
    `alter(args, output)` from its fourth call on: the set-up's three
    steps are sound, the window's are not."""
    calls, sound = [], getattr(api, name)

    def late(*a, **kw):
        calls.append(1)
        out = sound(*a, **kw)
        return out if len(calls) <= 3 else alter(a, out)
    return types.SimpleNamespace(**{**vars(api), name: late})


def _late_answers(api):
    """Each window step's image 1% and gradient 20% too large."""
    return _late(api, "render_l2_grad", lambda a, out: (
        out[0] * 1.01, out[1], {k: g * 1.2 for k, g in out[2].items()}))


def _late_update(api):
    """Each window step's Adam update 10% too large (its state drifts)."""
    return _late(api, "adam_step", lambda a, out: (
        {k: p + 1.1 * (out[0][k] - p) for k, p in a[0].items()}, out[1]))


GRAD_CELLS = [w["name"] for w in BENCH["workloads"]
              if manifest.traffic(w["traffic"])["entry"] == "grad_step"]


@pytest.mark.parametrize("cell,fault,numbers", [
    (c, f, n) for c in GRAD_CELLS for f, n in (
        (_late_answers, ("image_rel_l1", "grad_gap")),
        (_late_update, ("change_gap",)))])
def test_window_step_is_judged(cell, fault, numbers):
    """A grad cell's check judges a step of the window besides set-up's:
    a fault that starts after set-up reads not correct, on the numbers
    that it moves."""
    import mitsuba2_tpu_torch as mt
    out = _run(cell, api=fault(common.program_api(mt)))
    assert out["correct"] is False, out["checks"]
    for n in numbers:
        c = out["checks"][n]
        assert c["value"] > c["limit"], (n, out["checks"])


def test_nothing_forbidden_is_loaded():
    """The harness's modules and a run of each entry in a process of
    their own: no top-level module named jax, jaxlib, flax or
    mitsuba2_tpu (compared whole), and nothing of bench.py or
    benchmarks/."""
    code = (
        "import sys, time, json\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        "from gpubench import run, calibrate, manifest, faults, profile\n"
        "from gpubench.tests.conftest import tiny\n"
        "b = manifest.benchmark()\n"
        "for w in b['workloads']:\n"
        "    c = manifest.cell(b, w['name'])\n"
        "    run.run_cell(b, c, 1, 0.1, 1, 'cpu', time.monotonic(),\n"
        "                 traffic=tiny(manifest.traffic(c['traffic'])))\n"
        "    for m in b['per_layer']: manifest.metric_reader(m['name'])\n"
        "mods = sorted(m.split('.')[0] for m in sys.modules)\n"
        "print(json.dumps([run.forbidden_modules(), mods]))\n")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600, cwd=ROOT)
    assert p.returncode == 0, p.stderr[-2000:]
    bad, mods = json.loads(p.stdout.strip().splitlines()[-1])
    assert bad == []
    assert "mitsuba2_tpu_torch" in mods
    assert "bench" not in mods and "benchmarks" not in mods


def test_exits_without_a_card(card_absent):
    p = subprocess.run([sys.executable, "gpubench/run.py", "--workload",
                        "gallery-render", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], capture_output=True, text=True,
                       timeout=300, cwd=ROOT)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_exits_without_the_program(tmp_path):
    """A directory holding BENCHMARK.json and gpubench/ alone: no result,
    a non-zero exit, card or none."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "gpubench"), tmp_path / "gpubench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, "gpubench/run.py", "--workload",
                        "gallery-render", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], capture_output=True, text=True,
                       timeout=300, cwd=tmp_path, env=env)
    assert p.returncode != 0 and p.stdout.strip() == ""


@pytest.fixture
def card_absent():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the run would use it")


@pytest.mark.card
def test_cell_on_the_card(card):
    """One short run of the first cell, as the driver makes it."""
    w = BENCH["workloads"][0]["name"]
    p = subprocess.run([sys.executable, "gpubench/run.py", "--workload", w,
                        "--seed", "2147483901", "--seconds", "3",
                        "--trace", "0"], capture_output=True, text=True,
                       timeout=360, cwd=ROOT)
    assert p.returncode == 0, p.stderr[-3000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["correct"] is True and out["device"]["platform"] == "gpu"
