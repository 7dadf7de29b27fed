"""The port's tracing: spans, counters, the stage clock and the trace
exporter.

Tracing is on exactly while a torch profiler runs; there is no other
switch. With it off, `span` costs one boolean check and nothing else (no
`record_function`, no event, no kernel, no sync). With it on, a span

- opens a `record_function` range of its name, so that it sits in the
  profiler's timeline beside the CUDA kernels it launched;
- keeps a record in memory: name, the enclosing span of its thread, a batch
  or step id, host start and end (`perf_counter_ns`), and on a CUDA
  `device` a CUDA event at each end (recorded, never waited for);
- counts the synchronizing CUDA operations run inside it: while any span is
  open, torch's sync debug mode is "warn", and each such warning is counted
  against the innermost open span of its thread instead of being shown.

Open spans stack per thread (the compress writer runs in its own thread).
A span opened inside a span of the same name (a recursive call) is part of
it and keeps no record of its own.

`count` adds host integers into a tally that is always kept (`counters`,
`reset`); `count_device` adds device scalars, only while tracing is on.
`snapshot` sums the records: per span name its count, host seconds, device
seconds and syncs, and the counters counted inside spans. `StageClock` is
the one clock that synchronizes the device: each stage is a span, and with
`timings` it also adds the stage's seconds. `device_trace` records a
torch.profiler trace around a block and writes it as a Chrome trace
(chrome://tracing, Perfetto) beside the block's snapshot.

    python -m image_compression_torch.utils.profiling

prints the host cost of one span entered with tracing off and on.
"""

from __future__ import annotations

import contextlib
import json
import pathlib
import threading
import time
import warnings

import torch
from torch.autograd import profiler as _autograd_profiler
from torch.profiler import ProfilerActivity, profile, record_function

# the text of torch's warning for a synchronizing CUDA operation
SYNC_WARNING = "called a synchronizing CUDA operation"

_OFF = contextlib.nullcontext()
_lock = threading.Lock()
_local = threading.local()     # .stack: this thread's open spans
_records: list[_Span] = []     # closed spans, in the order they closed
_tally: dict[str, int] = {}    # count(): every call, traced or not
_sync_users = 0                # open outermost spans, over all threads
_sync_restore = None           # what _sync_off puts back


def tracing() -> bool:
    """True while a torch profiler runs. This is torch's process-wide flag:
    the profiler's own check, torch.autograd._profiler_enabled(), is false
    in threads it did not start in, such as the compress writer's."""
    return _autograd_profiler._is_profiler_enabled


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def _sync_on() -> None:
    """Turn on the counting of synchronizing CUDA operations (the first
    outermost span to open, in any thread)."""
    global _sync_users, _sync_restore
    with _lock:
        _sync_users += 1
        if _sync_users > 1 or not torch.cuda.is_initialized():
            return
        caught = warnings.catch_warnings()
        caught.__enter__()
        warnings.filterwarnings("always", message=SYNC_WARNING)
        show = warnings.showwarning

        def counted(message, *args, **kwargs):
            if not str(message).startswith(SYNC_WARNING):
                return show(message, *args, **kwargs)
            stack = _stack()
            if stack:
                stack[-1].syncs += 1

        warnings.showwarning = counted
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("warn")
        _sync_restore = (caught, mode)


def _sync_off() -> None:
    global _sync_users, _sync_restore
    with _lock:
        _sync_users -= 1
        if _sync_users > 0 or _sync_restore is None:
            return
        caught, mode = _sync_restore
        _sync_restore = None
        torch.cuda.set_sync_debug_mode(mode)
        caught.__exit__(None, None, None)


class _Span:
    __slots__ = ("name", "device", "id", "parent", "thread", "start_ns",
                 "end_ns", "events", "syncs", "counts", "device_counts",
                 "_range", "_nested")

    def __init__(self, name: str, device, id):
        self.name = name
        self.device = torch.device(device) if device is not None else None
        self.id = id
        self.syncs = 0
        self.counts: dict[str, int] = {}
        self.device_counts: dict[str, torch.Tensor] = {}
        self.events = None

    def _event(self):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(self.device))
        return ev

    def __enter__(self):
        stack = _stack()
        outer = stack[-1] if stack else None
        self._nested = outer is not None and outer.name == self.name
        if self._nested:
            return self
        self.parent = outer.name if outer is not None else None
        if self.id is None and outer is not None:
            self.id = outer.id
        self.thread = threading.current_thread().name
        if outer is None:
            _sync_on()
        self._range = record_function(self.name)
        self._range.__enter__()
        if self.device is not None and self.device.type == "cuda":
            self.events = (self._event(), None)
        stack.append(self)
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        if self._nested:
            return False
        self.end_ns = time.perf_counter_ns()
        if self.events is not None:
            self.events = (self.events[0], self._event())
        stack = _stack()
        stack.pop()
        self._range.__exit__(*exc)
        if stack:
            # a span's syncs include its children's
            stack[-1].syncs += self.syncs
        else:
            _sync_off()
        with _lock:
            _records.append(self)
        return False


def span(name: str, device: str | torch.device | None = None,
         id: int | None = None):
    """A context manager: the traced span `name` (module docstring), or
    nothing while tracing is off. On a CUDA `device` it also times the span
    on that device's current stream. `id` names the batch or step; a span
    without one takes its enclosing span's."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, device, id)


def count(name: str, n: int = 1) -> None:
    """Add n to counter `name`: always into the tally `counters()` reads,
    and while a span of this thread is open also into that span's."""
    with _lock:
        _tally[name] = _tally.get(name, 0) + n
    if _autograd_profiler._is_profiler_enabled:
        stack = _stack()
        if stack:
            stack[-1].counts[name] = stack[-1].counts.get(name, 0) + n


def count_device(name: str, value: torch.Tensor) -> None:
    """While tracing is on, add the device scalar `value` into counter
    `name` of this thread's innermost open span (one small kernel, no
    sync); otherwise nothing. Callers compute `value` only while
    `tracing()`."""
    if not _autograd_profiler._is_profiler_enabled:
        return
    stack = _stack()
    if not stack:
        return
    tally = stack[-1].device_counts
    tally[name] = tally[name] + value if name in tally else value


def counters() -> dict[str, int]:
    """The tally of every count() since the last reset()."""
    with _lock:
        return dict(_tally)


def reset() -> None:
    """Clear the tally and every span record."""
    with _lock:
        _tally.clear()
        _records.clear()


def records() -> list[dict]:
    """The closed spans, in the order they closed: name, parent (the
    enclosing span of its thread), id, thread, host start and end ns,
    syncs."""
    with _lock:
        done = list(_records)
    return [{"name": r.name, "parent": r.parent, "id": r.id,
             "thread": r.thread, "start_ns": r.start_ns, "end_ns": r.end_ns,
             "syncs": r.syncs} for r in done]


def snapshot() -> dict:
    """Synchronizes once (call it outside any span) and sums the records:
    {"spans": {name: {"count", "host_s", "device_s" (None without CUDA
    events), "syncs"}}, "counters": {name: value}}, the counters summed
    over the spans that counted them."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()
    with _lock:
        done = list(_records)
    spans: dict[str, dict] = {}
    totals: dict[str, float] = {}
    for r in done:
        s = spans.setdefault(r.name, {"count": 0, "host_s": 0.0,
                                      "device_s": None, "syncs": 0})
        s["count"] += 1
        s["host_s"] += (r.end_ns - r.start_ns) / 1e9
        s["syncs"] += r.syncs
        if r.events is not None:
            s["device_s"] = ((s["device_s"] or 0.0)
                             + r.events[0].elapsed_time(r.events[1]) / 1e3)
        for name, n in r.counts.items():
            totals[name] = totals.get(name, 0) + n
        for name, v in r.device_counts.items():
            totals[name] = totals.get(name, 0) + v.item()
    return {"spans": spans, "counters": totals}


class StageClock:
    """Stages of one batch or step. `stage(name)` is a span of that name on
    `device`; with `timings` (a dict) it also synchronizes the device when
    the stage ends and adds the stage's seconds under its name."""

    def __init__(self, timings: dict | None, device: str | torch.device):
        self.timings = timings
        self.device = torch.device(device)

    def stage(self, name: str):
        if self.timings is None:
            return span(name, self.device)
        return self._timed(name)

    @contextlib.contextmanager
    def _timed(self, name: str):
        t0 = time.perf_counter()
        with span(name, self.device):
            yield
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.timings[name] = (self.timings.get(name, 0.0)
                              + time.perf_counter() - t0)


class TraceHandle:
    """What `device_trace` yields: the profiler while the block runs, and
    the written trace's `path` and snapshot's `spans_path` after it."""

    def __init__(self, prof):
        self.profiler = prof
        self.path: pathlib.Path | None = None
        self.spans_path: pathlib.Path | None = None


@contextlib.contextmanager
def device_trace(log_dir: str | pathlib.Path):
    """Record a trace around a block (host and, where present, CUDA
    activity: every kernel with its name and device time), starting from no
    span records; on exit write it to log_dir/trace_<ns>.json, and the
    block's snapshot() with its records() to log_dir/spans_<ns>.json."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    log_dir = pathlib.Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    with _lock:
        _records.clear()
    with profile(activities=activities) as prof:
        handle = TraceHandle(prof)
        yield handle
    ns = time.time_ns()
    handle.path = log_dir / f"trace_{ns}.json"
    prof.export_chrome_trace(str(handle.path))
    handle.spans_path = log_dir / f"spans_{ns}.json"
    handle.spans_path.write_text(json.dumps(dict(snapshot(),
                                                 records=records())))


def _span_cost(n: int = 200_000) -> dict:
    """Host microseconds per span entered and left, tracing off and on (on:
    under a CPU profiler, without CUDA events)."""
    def per_span():
        t0 = time.perf_counter()
        for _ in range(n):
            with span("x"):
                pass
        return 1e6 * (time.perf_counter() - t0) / n

    def per_empty():
        t0 = time.perf_counter()
        for _ in range(n):
            with _OFF:
                pass
        return 1e6 * (time.perf_counter() - t0) / n

    out = {"empty_with_us": per_empty(), "off_us": per_span()}
    n //= 20
    with profile(activities=[ProfilerActivity.CPU]):
        out["on_us"] = per_span()
    reset()
    return out


if __name__ == "__main__":
    print(json.dumps(_span_cost()))
