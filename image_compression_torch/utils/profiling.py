"""Tracing and profiling hooks.

Port of the reference's utils/profiling.py: `device_trace` records a
torch.profiler trace (CPU and, where present, CUDA activity: every kernel
launch with its name and device time) and writes it as a Chrome trace
(chrome://tracing, Perfetto) into a directory; `PhaseTimer` accumulates
wall-clock seconds per named phase and prints one JSON line; `annotate`
names a range in the trace.
"""

from __future__ import annotations

import contextlib
import json
import pathlib
import time

import torch
from torch.profiler import ProfilerActivity, profile, record_function


class TraceHandle:
    """What `device_trace` yields: the profiler while the block runs, and
    the written trace's `path` after it."""

    def __init__(self, prof):
        self.profiler = prof
        self.path: pathlib.Path | None = None


@contextlib.contextmanager
def device_trace(log_dir: str | pathlib.Path):
    """Record a trace around a block; on exit write it to
    log_dir/trace_<ns>.json."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    log_dir = pathlib.Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        handle = TraceHandle(prof)
        yield handle
    handle.path = log_dir / f"trace_{time.time_ns()}.json"
    prof.export_chrome_trace(str(handle.path))


def _synchronize(tree) -> None:
    """Wait for the devices of every CUDA tensor in `tree`."""
    if isinstance(tree, torch.Tensor):
        if tree.device.type == "cuda":
            torch.cuda.synchronize(tree.device)
    elif isinstance(tree, dict):
        for v in tree.values():
            _synchronize(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _synchronize(v)


class PhaseTimer:
    """Accumulates wall-clock per named phase; emits one JSON line."""

    def __init__(self):
        self.totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str, block_on=None):
        """Time the block; `block_on` (tensors) is synchronized first, so
        that the phase includes the device work it queued."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if block_on is not None:
                _synchronize(block_on)
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self) -> dict:
        return {name: {"total_s": round(total, 4),
                       "count": self.counts[name],
                       "mean_ms": round(1e3 * total / self.counts[name], 3)}
                for name, total in self.totals.items()}

    def log(self, out=print):
        out(json.dumps({"phase_timings": self.summary()}))


def annotate(name: str):
    """A named range in the profiler trace (a context manager)."""
    return record_function(name)
