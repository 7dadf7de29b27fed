"""utils/profiling.py, the port's tracing: spans and counters off and on,
the Chrome trace and the snapshot, and the spans the program opens in a
classical compress and a REINFORCE step. CPU, a few seconds; the cases
marked `cuda` count syncs and read device time on a card and skip
without one. This file imports no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_tracing.py
"""

import collections
import contextlib
import json
import threading
import time

import numpy as np
import pytest
import torch

from image_compression_torch import pipeline
from image_compression_torch.config import Config, EdgeTarget
from image_compression_torch.io import pypng
from image_compression_torch.ops import graph_based, graph_based_hier
from image_compression_torch.ops import merge_refine
from image_compression_torch.utils import profiling
from image_compression_torch.utils.profiling import (count, count_device,
                                                     counters, device_trace,
                                                     records, snapshot, span)


@pytest.fixture(autouse=True)
def fresh():
    profiling.reset()
    yield
    profiling.reset()


def test_span_off_is_nothing(monkeypatch):
    """With no profiler running a span opens no record_function range and
    keeps no record; count() still adds to the tally, and count_device()
    does nothing."""
    opened = []
    monkeypatch.setattr(profiling, "record_function",
                        lambda name: opened.append(name))
    assert not profiling.tracing()
    with span("outer", "cpu", id=3):
        with span("inner"):
            torch.ones(4) + 1
            count("n", 2)
            count_device("d", torch.ones((), dtype=torch.int64))
    assert opened == [] and records() == []
    assert counters() == {"n": 2}
    assert snapshot() == {"spans": {}, "counters": {}}


def test_chrome_trace_holds_the_spans(tmp_path):
    """Under device_trace each span is a range of the trace enclosing the
    ops run inside it; parents and ids nest; a span in another thread
    sits on that thread's own stack and keeps the id it is given."""
    def writer():
        with span("write", id=7):
            torch.ones(8) * 2

    with device_trace(tmp_path) as handle:
        with span("outer", id=7):
            with span("inner"):
                torch.ones(64, 64) @ torch.ones(64, 64)
            worker = threading.Thread(target=writer, name="writer")
            worker.start()
            worker.join(timeout=30)
    assert not worker.is_alive()
    events = json.loads(handle.path.read_text())["traceEvents"]
    ranges = {e["name"]: e for e in events if e.get("ph") == "X"
              and e["name"] in ("outer", "inner")}
    mm = [e for e in events if e.get("name") == "aten::mm"]
    assert set(ranges) == {"outer", "inner"} and len(mm) == 1

    def inside(a, b):
        return b["ts"] <= a["ts"] and a["ts"] + a["dur"] <= b["ts"] + b["dur"]

    assert inside(mm[0], ranges["inner"])
    assert inside(ranges["inner"], ranges["outer"])
    got = {r["name"]: r for r in records()}
    assert got["inner"]["parent"] == "outer" and got["inner"]["id"] == 7
    assert got["outer"]["parent"] is None and got["outer"]["id"] == 7
    assert got["write"]["parent"] is None and got["write"]["id"] == 7
    assert got["write"]["thread"] == "writer"
    assert got["write"]["thread"] != got["outer"]["thread"]
    assert (got["outer"]["start_ns"] <= got["inner"]["start_ns"]
            <= got["inner"]["end_ns"] <= got["outer"]["end_ns"])
    written = json.loads(handle.spans_path.read_text())
    assert written["spans"]["inner"]["count"] == 1
    assert len(written["records"]) == 3


def test_snapshot_format(tmp_path):
    """snapshot(): per span name count, host seconds, device seconds (None
    without a card) and syncs; the counters counted inside spans, host and
    device; a recursive span is part of its caller's."""
    with device_trace(tmp_path):
        count("outside")
        for _ in range(2):
            with span("solve", "cpu"):
                with span("solve"):
                    count("calls", 3)
                count_device("images", torch.tensor(2))
    snap = snapshot()
    assert set(snap) == {"spans", "counters"}
    assert set(snap["spans"]) == {"solve"}
    solve = snap["spans"]["solve"]
    assert set(solve) == {"count", "host_s", "device_s", "syncs"}
    assert solve["count"] == 2 and solve["syncs"] == 0
    assert solve["host_s"] > 0 and solve["device_s"] is None
    assert snap["counters"] == {"calls": 6, "images": 4}
    assert counters() == {"outside": 1, "calls": 6}


def _corpus(root):
    """Six 64x64 PNGs: three of four distinct quadrants (graph costs keep
    a slicing) and three of noise (declined: one region)."""
    rng = np.random.default_rng(5)
    root.mkdir()
    for i in range(6):
        img = rng.integers(0, 256, (64, 64, 3), np.uint8)
        if i % 2 == 0:
            img[:32, :32] = rng.integers(0, 16, (32, 32, 3))
            img[:32, 32:] = (200, 0, 0)
            img[32:, 32:] = np.arange(32, dtype=np.uint8)[None, :, None] * 8
        (root / f"im{i}.png").write_bytes(pypng.encode(img))
    return root


def test_compress_directory_spans(tmp_path, monkeypatch):
    """A classical (GRAPH) compress of 3 batches of 2 records 3 batches,
    each with its load and the wait for its write; the writes run in the
    worker's thread under their batch's id; merge.noop_images counts the
    one-region (all-zero) label planes merge refinement received."""
    noop = []
    merge = pipeline.merge_refine_batch

    def counted_merge(images, labels, **kw):
        noop.append(int((labels.flatten(1) == 0).all(dim=1).sum()))
        return merge(images, labels, **kw)

    monkeypatch.setattr(pipeline, "merge_refine_batch", counted_merge)
    cfg = Config(dataset_dir=str(_corpus(tmp_path / "data")),
                 results_dir=str(tmp_path / "out"))
    with device_trace(tmp_path / "trace"):
        dirs = pipeline.compress_directory(cfg, classical=EdgeTarget.GRAPH,
                                           batch_size=2, device="cpu")
    assert len(dirs) == 6
    spans = snapshot()["spans"]
    for name in ("compress.batch", "load", "write_wait", "write", "costs",
                 "solver", "multicut", "fallback", "merge", "wire"):
        assert spans[name]["count"] == 3, name
    got = records()
    batches = [r for r in got if r["name"] == "compress.batch"]
    assert [r["id"] for r in batches] == [0, 1, 2]
    assert {r["parent"] for r in got if r["name"] in ("load", "costs",
                                                      "merge")} == {
        "compress.batch"}
    writes = [r for r in got if r["name"] == "write"]
    assert sorted(r["id"] for r in writes) == [0, 1, 2]
    assert {r["parent"] for r in writes} == {None}
    assert {r["thread"] for r in writes}.isdisjoint(
        {r["thread"] for r in batches})
    waits = [r for r in got if r["name"] == "write_wait"]
    assert [r["id"] for r in waits] == [0, 1, 2]
    assert len(noop) == 3 and 0 < sum(noop) < 6
    assert snapshot()["counters"]["merge.noop_images"] == sum(noop)


def test_declined_batch_skips_merge(tmp_path, monkeypatch):
    """A traced compress batch of noise images, every one declined: merge
    refinement counts each as merge.noop_images and runs no round, so no
    merge.greedy span is recorded."""
    declined = []
    merge = pipeline.merge_refine_batch

    def checked_merge(images, labels, **kw):
        declined.append(bool((labels == 0).all()))
        return merge(images, labels, **kw)

    monkeypatch.setattr(pipeline, "merge_refine_batch", checked_merge)
    rng = np.random.default_rng(6)
    data = tmp_path / "data"
    data.mkdir()
    for i in range(3):
        (data / f"noise{i}.png").write_bytes(pypng.encode(
            rng.integers(0, 256, (64, 64, 3), np.uint8)))
    cfg = Config(dataset_dir=str(data), results_dir=str(tmp_path / "out"))
    with device_trace(tmp_path / "trace"):
        dirs = pipeline.compress_directory(cfg, classical=EdgeTarget.GRAPH,
                                           batch_size=3, device="cpu")
    assert len(dirs) == 3 and declined == [True]
    snap = snapshot()
    assert snap["spans"]["compress.batch"]["count"] == 1
    assert snap["spans"]["merge"]["count"] == 1
    assert snap["counters"]["merge.noop_images"] == 3
    assert "merge.greedy" not in {r["name"] for r in records()}


def test_graph_compress_counters(tmp_path, monkeypatch):
    """A traced GRAPH compress records the span "graph" under each batch's
    "costs" and the counters graph.rounds, compress.kept_images,
    compress.guard_rewrites and merge.pairs: the kept images are those
    written as several slices or rewritten by the guard, and the pairs
    merged are the regions that merge refinement took away."""
    merged = []
    merge = pipeline.merge_refine_batch

    def regions(labels):
        return sum(len(torch.unique(im)) for im in labels)

    def counted_merge(images, labels, **kw):
        out = merge(images, labels, **kw)
        merged.append(regions(labels) - regions(out))
        return out

    monkeypatch.setattr(pipeline, "merge_refine_batch", counted_merge)
    cfg = Config(dataset_dir=str(_corpus(tmp_path / "data")),
                 results_dir=str(tmp_path / "out"))
    with device_trace(tmp_path / "trace"):
        dirs = pipeline.compress_directory(cfg, classical=EdgeTarget.GRAPH,
                                           batch_size=2, device="cpu")
    snap = snapshot()
    assert snap["spans"]["graph"]["count"] == 3
    assert {r["parent"] for r in records() if r["name"] == "graph"} == {
        "costs"}
    got = snap["counters"]
    sliced = sum(len(list(d.glob("slice_*.png"))) > 1 for d in dirs)
    assert sliced >= 1
    assert got["compress.kept_images"] == sliced + got[
        "compress.guard_rewrites"]
    assert got["merge.pairs"] == sum(merged) > 0
    # 256-pixel-wide levels and the absorption: at least one round each
    assert got["graph.rounds"] >= 3 * 3


# tensor calls that wait for the device when their tensor lives on a card
SYNCING = {"item", "__bool__", "__int__", "__float__", "__index__", "tolist",
           "numpy", "cpu", "equal", "nonzero"}


class _SyncingCalls(torch.overrides.TorchFunctionMode):
    """Counts each call of SYNCING against every span open in its thread,
    as the program's sync count adds a span's syncs into its parents'."""

    def __init__(self):
        super().__init__()
        self.calls = collections.Counter()
        self.total = 0  # inside spans or not

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if getattr(func, "__name__", "") in SYNCING:
            self.calls.update({s.name for s in profiling._stack()})
            self.total += 1
        return func(*args, **(kwargs or {}))


def _without_new_instrumentation(monkeypatch):
    """The graph span and the counters graph.rounds, compress.kept_images,
    compress.guard_rewrites and merge.pairs made no-ops."""
    def no_count(*_args):
        return None

    for module in (pipeline, graph_based, graph_based_hier):
        monkeypatch.setattr(module, "count", no_count)
    monkeypatch.setattr(merge_refine, "count_device", no_count)
    traced = pipeline.span
    monkeypatch.setattr(pipeline, "span", lambda name, *a, **k: (
        contextlib.nullcontext() if name == "graph"
        else traced(name, *a, **k)))


def test_graph_instrumentation_adds_no_sync(tmp_path, monkeypatch):
    """The graph span and the four counters add no call that waits for the
    device to any span: each span's count of such calls in a traced GRAPH
    compress is the same with them and without them."""
    data = _corpus(tmp_path / "data")

    def syncing_calls(tag):
        cfg = Config(dataset_dir=str(data),
                     results_dir=str(tmp_path / tag))
        with _SyncingCalls() as mode, device_trace(tmp_path / f"t{tag}"):
            pipeline.compress_directory(cfg, classical=EdgeTarget.GRAPH,
                                        batch_size=2, device="cpu")
        return mode.calls

    live = syncing_calls("live")
    _without_new_instrumentation(monkeypatch)
    bare = syncing_calls("bare")
    assert live.pop("graph") > 0
    assert live == bare and live["costs"] > 0 and live["merge"] > 0


def _graph_job(data, out, traced=True, mode=None, batch_size=2):
    """A GRAPH compress of `data`, traced or not, inside the torch function
    `mode` if one is given (which so sees none of the trace's own
    calls)."""
    cfg = Config(dataset_dir=str(data), results_dir=str(out))
    with (device_trace(out.with_name(out.name + "_trace")) if traced
          else contextlib.nullcontext()), (mode or contextlib.nullcontext()):
        return pipeline.compress_directory(cfg, classical=EdgeTarget.GRAPH,
                                           batch_size=batch_size,
                                           device="cpu")


def test_load_span_waits_on_the_main_thread(tmp_path):
    """Traced, each batch's "load" (the wait for its decoded images) sits
    under its compress.batch on the main thread, and each image's
    "load.decode" runs on a decode thread, outside any span, with its
    batch's id."""
    _graph_job(_corpus(tmp_path / "data"), tmp_path / "out")
    got = records()
    main = {r["thread"] for r in got if r["name"] == "compress.batch"}
    loads = [r for r in got if r["name"] == "load"]
    assert len(main) == 1 and len(loads) == 3
    assert {(r["thread"], r["parent"]) for r in loads} == {
        (*main, "compress.batch")}
    decodes = [r for r in got if r["name"] == "load.decode"]
    assert sorted(r["id"] for r in decodes) == [0, 0, 1, 1, 2, 2]
    assert {r["parent"] for r in decodes} == {None}
    assert all(r["thread"].startswith("decode") for r in decodes)


def test_ready_images_counted_only_while_traced(tmp_path, monkeypatch):
    """Untraced, the decode pool records no span and counts nothing.
    Traced, load.ready_images counts the batch's images decoded before
    its wait: 0 for one batch of slow decodes (and still counted), the
    later batches' images where the device half outlasts the decodes."""
    data = _corpus(tmp_path / "data")
    _graph_job(data, tmp_path / "off", traced=False)
    assert records() == []
    assert "load.ready_images" not in counters()

    load, labels = pipeline.load_image, pipeline._device_labels

    def slow_load(path):
        time.sleep(0.4)
        return load(path)

    monkeypatch.setattr(pipeline, "load_image", slow_load)
    _graph_job(data, tmp_path / "slow", batch_size=6)
    assert snapshot()["counters"]["load.ready_images"] == 0

    def slow_labels(*args, **kwargs):
        time.sleep(0.3)
        return labels(*args, **kwargs)

    monkeypatch.setattr(pipeline, "load_image", load)
    monkeypatch.setattr(pipeline, "_device_labels", slow_labels)
    _graph_job(data, tmp_path / "fast")
    assert 4 <= snapshot()["counters"]["load.ready_images"] <= 6


def test_decode_pool_adds_no_sync(tmp_path, monkeypatch):
    """The calls that wait for the device are those of the same job without
    tracing, and per span those of a traced job without load.decode and
    load.ready_images: the pool and its instrumentation add none."""
    data = _corpus(tmp_path / "data")

    def syncing_calls(tag, traced=True):
        mode = _SyncingCalls()
        _graph_job(data, tmp_path / tag, traced, mode)
        return mode

    live = syncing_calls("live")
    untraced = syncing_calls("untraced", traced=False)
    traced = pipeline.span
    monkeypatch.setattr(pipeline, "tracing", lambda: False)
    monkeypatch.setattr(pipeline, "span", lambda name, *a, **k: (
        contextlib.nullcontext() if name == "load.decode"
        else traced(name, *a, **k)))
    bare = syncing_calls("bare")
    assert live.total == untraced.total == bare.total > 0
    assert live.calls == bare.calls and live.calls["costs"] > 0
    assert "load.decode" not in live.calls


def test_costs_input_span_only_while_traced(tmp_path):
    """Untraced, the batch's preparation records nothing. Traced, it is the
    host span "costs.input" (no device events) under each batch's "costs",
    on the main thread, with the batch's id."""
    data = _corpus(tmp_path / "data")
    _graph_job(data, tmp_path / "off", traced=False)
    assert records() == []
    _graph_job(data, tmp_path / "on")
    got = records()
    inputs = [r for r in got if r["name"] == "costs.input"]
    main = {r["thread"] for r in got if r["name"] == "costs"}
    assert [r["id"] for r in inputs] == [0, 1, 2]
    assert {(r["parent"], r["thread"]) for r in inputs} == {("costs",
                                                             *main)}
    costs = [r for r in got if r["name"] == "costs"]
    for inner, outer in zip(inputs, costs):
        assert (outer["start_ns"] <= inner["start_ns"] <= inner["end_ns"]
                <= outer["end_ns"])
    assert snapshot()["spans"]["costs.input"]["device_s"] is None


def test_costs_input_adds_no_sync(tmp_path, monkeypatch):
    """The calls that wait for the device are those of the same job without
    tracing, and per span those of a traced job without "costs.input"."""
    data = _corpus(tmp_path / "data")

    def syncing_calls(tag, traced=True):
        mode = _SyncingCalls()
        _graph_job(data, tmp_path / tag, traced, mode)
        return mode

    live = syncing_calls("live")
    untraced = syncing_calls("untraced", traced=False)
    traced = pipeline.span
    monkeypatch.setattr(pipeline, "span", lambda name, *a, **k: (
        contextlib.nullcontext() if name == "costs.input"
        else traced(name, *a, **k)))
    bare = syncing_calls("bare")
    assert live.total == untraced.total == bare.total > 0
    live.calls.pop("costs.input", None)
    assert live.calls == bare.calls and live.calls["costs"] > 0


def _learned_job(data, out, traced=True, mode=None):
    """A learned compress of `data` with a seeded bf16 U-Net of base 8 in
    batches of 2 on the CPU, traced or not, inside the torch function
    `mode` if one is given."""
    from image_compression_torch.models.unet import EdgeUNet, init_random_
    model = init_random_(EdgeUNet(base=8), seed=0)
    cfg = Config(dataset_dir=str(data), results_dir=str(out))
    with (device_trace(out.with_name(out.name + "_trace")) if traced
          else contextlib.nullcontext()), (mode or contextlib.nullcontext()):
        return pipeline.compress_directory(cfg, model, batch_size=2,
                                           device="cpu")


def test_unet_norms_counted_only_while_traced(tmp_path):
    """Untraced, the U-Net counts nothing. Traced, unet.norms counts its 14
    norms a batch inside each batch's "costs", and unet.norms_fused those
    the kernel ran: none on the CPU, counted as 0."""
    data = _corpus(tmp_path / "data")
    _learned_job(data, tmp_path / "off", traced=False)
    assert not {"unet.norms", "unet.norms_fused"} & set(counters())
    _learned_job(data, tmp_path / "on")
    got = snapshot()["counters"]
    assert got["unet.norms"] == 14 * 3 and got["unet.norms_fused"] == 0


def test_unet_norm_counters_add_no_sync(tmp_path, monkeypatch):
    """The calls that wait for the device are those of the same learned job
    without tracing, and per span those of a traced job whose U-Net counts
    nothing."""
    from image_compression_torch.models import unet
    data = _corpus(tmp_path / "data")

    def syncing_calls(tag, traced=True):
        mode = _SyncingCalls()
        _learned_job(data, tmp_path / tag, traced, mode)
        return mode

    live = syncing_calls("live")
    untraced = syncing_calls("untraced", traced=False)
    monkeypatch.setattr(unet, "count", lambda *_args: None)
    bare = syncing_calls("bare")
    assert live.total == untraced.total == bare.total > 0
    assert live.calls == bare.calls and live.calls["costs"] > 0


def test_rl_step_spans(tmp_path):
    """A tiny REINFORCE step records sample, multicut and reward under
    solve_reward, the three stages under rl.step, all with the step's id."""
    from image_compression_torch.models.unet import EdgeUNet, init_random_
    from image_compression_torch.ops import prng
    from image_compression_torch.train import steps

    cfg = Config()
    cfg.reward.max_segments = 16
    model = init_random_(EdgeUNet(base=8, dtype=torch.float32), seed=0)
    state = steps.init_rl_state(model, cfg)
    images = torch.as_tensor(
        np.random.default_rng(1).random((2, 32, 32, 3)).astype(np.float32))
    sizes = torch.tensor([2600.0, 2900.0])
    with device_trace(tmp_path):
        steps.make_rl_step(cfg)(state, prng.prng_key(0), images, sizes)
    parents = {r["name"]: (r["parent"], r["id"]) for r in records()}
    assert parents["rl.step"] == (None, 0)
    for stage in ("forward", "solve_reward", "update"):
        assert parents[stage] == ("rl.step", 0)
    for name in ("sample", "multicut", "reward"):
        assert parents[name] == ("solve_reward", 0)
    assert snapshot()["spans"]["multicut"]["count"] == 1


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: syncs and device time exist only on "
                    "the card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_syncs_and_device_time_on_card(cuda, tmp_path):
    """A nonzero inside a span counts one sync, a sum none; spans on the
    card have device seconds; the sync debug mode is restored."""
    x = torch.arange(1000, device=cuda) % 3
    mode = torch.cuda.get_sync_debug_mode()
    with device_trace(tmp_path):
        with span("step", cuda):
            with span("nonzero", cuda):
                x.nonzero()
            with span("sum", cuda):
                x.sum()
    assert torch.cuda.get_sync_debug_mode() == mode
    spans = snapshot()["spans"]
    assert spans["nonzero"]["syncs"] == 1 and spans["sum"]["syncs"] == 0
    assert spans["step"]["syncs"] == 1
    assert all(s["device_s"] is not None and s["device_s"] >= 0
               for s in spans.values())


@pytest.mark.cuda
def test_costs_input_waits_for_nothing_on_card(cuda, tmp_path):
    """On a card, once a job has built the tables and the page-locked
    buffer, the batch's preparation (stack, upload, gather) counts no
    sync and has no device events of its own."""
    data = _corpus(tmp_path / "data")
    pipeline.compress_directory(
        Config(dataset_dir=str(data), results_dir=str(tmp_path / "warm")),
        classical=EdgeTarget.GRAPH, batch_size=2, device=cuda)
    with device_trace(tmp_path / "trace"):
        pipeline.compress_directory(
            Config(dataset_dir=str(data), results_dir=str(tmp_path / "out")),
            classical=EdgeTarget.GRAPH, batch_size=2, device=cuda)
    inputs = snapshot()["spans"]["costs.input"]
    assert inputs["count"] == 3 and inputs["syncs"] == 0
    assert inputs["device_s"] is None


@pytest.mark.cuda
def test_graph_instrumentation_adds_no_sync_on_card(cuda, tmp_path,
                                                    monkeypatch):
    """On a card: each span's count of syncs in a traced GRAPH compress is
    the same with the graph span and the four counters and without them;
    the graph span counts the FH rounds' fixpoint tests."""
    data = _corpus(tmp_path / "data")

    def syncs(tag):
        cfg = Config(dataset_dir=str(data),
                     results_dir=str(tmp_path / tag))
        with device_trace(tmp_path / f"t{tag}"):
            pipeline.compress_directory(cfg, classical=EdgeTarget.GRAPH,
                                        batch_size=2, device=cuda)
        return {name: s["syncs"] for name, s in snapshot()["spans"].items()}

    pipeline.compress_directory(
        Config(dataset_dir=str(data), results_dir=str(tmp_path / "warm")),
        classical=EdgeTarget.GRAPH, batch_size=2, device=cuda)
    live = syncs("live")
    _without_new_instrumentation(monkeypatch)
    bare = syncs("bare")
    assert live.pop("graph") > 0
    assert live == bare


@pytest.mark.cuda
def test_unet_norms_fused_on_card(cuda, tmp_path):
    """On a card a traced learned compress runs every norm through the
    kernel: unet.norms_fused equals unet.norms, 14 a batch."""
    from image_compression_torch.models.unet import EdgeUNet, init_random_
    data = _corpus(tmp_path / "data")
    model = init_random_(EdgeUNet(base=8), seed=0)
    with device_trace(tmp_path / "trace"):
        pipeline.compress_directory(
            Config(dataset_dir=str(data), results_dir=str(tmp_path / "out")),
            model, batch_size=2, device=cuda)
    got = snapshot()["counters"]
    assert got["unet.norms"] == got["unet.norms_fused"] == 14 * 3
