"""Device trace of a short steady span: torch.profiler over a callable,
reduced to what the per-layer readers and the result's `breakdown` need.

The span is a `record_function` range around the callable. Kernel events
(category "kernel") are kept where they overlap it; busy time is the union
of their intervals, clipped to the span. Idle gaps are the holes in that
union inside the span, each named by the innermost benchmark range and the
innermost host operation running at its midpoint ("python" where no
operation runs: the interpreter between calls).
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import tempfile

SPAN = "portbench.span"
STAGE_PREFIX = "portbench."
NAME_CHARS = 200  # kernel names are C++ template signatures


def _merge(intervals):
    out = []
    for t0, t1 in sorted(intervals):
        if out and t0 <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t1)
        else:
            out.append([t0, t1])
    return out


def _innermost(events, starts, t):
    """The shortest event of `events` (sorted by start) covering time t."""
    best = None
    i = bisect.bisect_right(starts, t)
    for e in reversed(events[max(0, i - 256):i]):
        if e["ts"] <= t <= e["ts"] + e["dur"]:
            if best is None or e["dur"] < best["dur"]:
                best = e
    return best


def reduce(events: list[dict]) -> dict | None:
    """Chrome-trace events -> {"span_s", "busy_s", "kernels": [(name, dur_s)
    ...], "device_ops": [[name, s], ...], "idle_gaps": [[name, s], ...]},
    or None when the trace holds no span or no kernel inside it."""
    spans = [e for e in events if e.get("name") == SPAN
             and e.get("ph") == "X"]
    if not spans:
        return None
    span = max(spans, key=lambda e: e["dur"])
    s0, s1 = span["ts"], span["ts"] + span["dur"]
    kernels = [e for e in events if e.get("cat") == "kernel"
               and e.get("ph") == "X" and e["ts"] < s1
               and e["ts"] + e["dur"] > s0]
    if not kernels:
        return None
    union = _merge((max(e["ts"], s0), min(e["ts"] + e["dur"], s1))
                   for e in kernels)
    busy = sum(t1 - t0 for t0, t1 in union)
    by_name: dict[str, float] = {}
    for e in kernels:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"]
    host = sorted((e for e in events if e.get("ph") == "X"
                   and e.get("cat") in ("cpu_op", "user_annotation")
                   and e.get("name") != SPAN), key=lambda e: e["ts"])
    stages = [e for e in host if e["name"].startswith(STAGE_PREFIX)]
    ops = [e for e in host if not e["name"].startswith(STAGE_PREFIX)]
    op_starts = [e["ts"] for e in ops]
    edges = [s0] + [t for iv in union for t in iv] + [s1]
    holes = sorted(((g1 - g0, g0, g1) for g0, g1 in zip(edges[0::2],
                                                         edges[1::2])
                    if g1 > g0), reverse=True)[:10]
    gaps = []
    for dur, g0, g1 in holes:
        mid = 0.5 * (g0 + g1)
        st = min((e for e in stages if e["ts"] <= mid <= e["ts"] + e["dur"]),
                 key=lambda e: e["dur"], default=None)
        op = _innermost(ops, op_starts, mid)
        label = "/".join(x for x in (
            st["name"][len(STAGE_PREFIX):] if st else None,
            op["name"] if op else "python") if x)
        gaps.append((dur, label))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])
    return {"span_s": (s1 - s0) / 1e6, "busy_s": busy / 1e6,
            "kernels": [(e["name"], e["dur"] / 1e6) for e in kernels],
            "device_ops": [[n[:NAME_CHARS], d / 1e6] for n, d in top[:10]],
            "idle_gaps": [[n, d / 1e6] for d, n in gaps[:10]]}


@contextlib.contextmanager
def stage(name: str):
    """A benchmark range named portbench.<name> (no cost when no profiler
    runs beyond the range object itself)."""
    import torch
    with torch.profiler.record_function(STAGE_PREFIX + name):
        yield


def profile(fn) -> dict | None:
    """Runs fn() once under torch.profiler (host and CUDA activity) inside
    the span range, synchronizes, and returns reduce() of its trace. The
    trace file goes to the temporary directory and is deleted."""
    import torch
    from torch.profiler import ProfilerActivity
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(SPAN):
            fn()
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(prefix="portbench-trace-", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    return reduce(events)
