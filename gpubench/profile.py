"""The reduction of a torch.profiler trace of whole frames to the
numbers the per-layer metrics read: the device operations with their
intervals, the device's busy time (the union of its operations'
intervals) within the traced window, and its idle gaps, each named by
the harness's span and the host operation under way when it began.
chip_smoke.py's phase 5 has the same method (device time by kernel,
busy share of the wall time); this copy is the yardstick's own."""
from __future__ import annotations

import dataclasses
import re
from typing import List, Tuple

SPAN = "gpubench."          # the harness's own record_function ranges
WINDOW = SPAN + "traced"    # the range around the traced frames
WALK = re.compile(r"(closest|any)_hit")
COPY = re.compile(r"^(Memcpy|Memset)")


@dataclasses.dataclass
class Trace:
    ops: List[Tuple[str, int, int]]    # device ops: (name, start, end) ns
    cpu: List[Tuple[str, int, int]]    # host ops and spans
    window: Tuple[int, int]            # the traced frames, host ns
    frames: int

    @property
    def kernels(self):
        return [o for o in self.ops if not COPY.match(o[0])]

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-9


def _get(e, name, fallback=None):
    f = getattr(e, name, None)
    return f() if callable(f) else fallback


def collect(prof, frames: int) -> Trace:
    """The trace of a finished profiler run whose traced frames ran inside
    a record_function(WINDOW) range."""
    from torch.autograd import DeviceType
    events = prof.profiler.kineto_results.events()
    spans = {e.name() for e in events
             if e.device_type() == DeviceType.CPU
             and _get(e, "is_user_annotation", False)}
    spans.add(WINDOW)
    ops, cpu = [], []
    for e in events:
        start = _get(e, "start_ns")
        end = start + _get(e, "duration_ns")
        name = e.name()
        if e.device_type() == DeviceType.CPU:
            cpu.append((name, start, end))
        elif (e.device_type() == DeviceType.CUDA and name not in spans
              and not _get(e, "is_user_annotation", False)):
            ops.append((name, start, end))
    win = [c for c in cpu if c[0] == WINDOW]
    if not win:
        raise RuntimeError("the trace holds no traced window")
    window = (win[0][1], win[0][2])
    ops = sorted(o for o in ops if o[2] > window[0] and o[1] < window[1])
    return Trace(ops=ops, cpu=sorted(cpu, key=lambda c: c[1]), window=window,
                 frames=frames)


def _union(intervals, lo, hi):
    """The merged [start, end) intervals, clipped to [lo, hi]."""
    merged = []
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def busy_s(tr: Trace) -> float:
    """Seconds of the traced window in which a device operation ran."""
    return sum(e - s for s, e in _union([(o[1], o[2]) for o in tr.ops],
                                        *tr.window)) * 1e-9


def device_seconds(tr: Trace, pattern=None) -> float:
    """Summed device time of the operations whose name matches."""
    return sum(o[2] - o[1] for o in tr.ops
               if pattern is None or pattern.search(o[0])) * 1e-9


def walk_roofline_pct(tr: Trace, traffic: dict, n_prims: int):
    """The traversal kernels' share of their roofline, %: the least time
    the card could take for the bytes a frame's traversals must move
    (raycount.walk_bytes: each wavefront's rays read once, its answers
    written once, the triangles once; fixed by the traffic's shapes,
    whatever kernel walks) at the data sheet's HBM rate, over the walk
    kernels' device time. Memory bound: a walk does a few hundred FLOPs a
    ray, far under the FP32 rate's share. None where no walk ran."""
    from gpubench import peaks, raycount
    s = device_seconds(tr, WALK)
    if s <= 0:
        return None
    bound = (raycount.walk_bytes(traffic, n_prims) * tr.frames
             / peaks.HBM_BYTES_PER_S)
    return 100.0 * bound / s


def top_ops(tr: Trace, n: int = 10):
    """[[name, seconds], ...]: the device operations that took most time,
    summed by name."""
    tot = {}
    for name, s, e in tr.ops:
        tot[name] = tot.get(name, 0) + (e - s)
    return [[k[:200], v * 1e-9]
            for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:n]]


def _host_at(tr: Trace, t: int) -> str:
    """The innermost harness span and innermost host op around time t."""
    span, op = "", "python"
    span_len = op_len = None
    for name, s, e in tr.cpu:
        if s > t:
            break
        if e < t:
            continue
        if name.startswith(SPAN) and name != WINDOW:
            if span_len is None or e - s < span_len:
                span, span_len = name[len(SPAN):], e - s
        elif not name.startswith(SPAN):
            if op_len is None or e - s < op_len:
                op, op_len = name, e - s
    return f"{span or 'harness'}: {op}"[:200]


def idle_gaps(tr: Trace, n: int = 10):
    """[[label, seconds], ...]: the longest stretches of the window with
    no device operation running, named by what the host was doing when
    each began."""
    busy = _union([(o[1], o[2]) for o in tr.ops], *tr.window)
    edges = [tr.window[0]] + [x for iv in busy for x in iv] + [tr.window[1]]
    gaps = [(edges[i + 1] - edges[i], edges[i])
            for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]
    gaps.sort(reverse=True)
    return [[_host_at(tr, start), length * 1e-9]
            for length, start in gaps[:n]]
