"""Each per-layer reader on a canned timings dict, a canned Chrome trace
and a canned snapshot of the program's spans and counters; the trace
reduction itself."""

import pytest

from portbench import harness, trace
from portbench.cost import model as cost
from image_compression_torch.utils import profiling

BENCH = harness.manifest()
CONFIG = {"compress": harness.cell_spec("flagship.mixed1024")["config"],
          "rl": harness.cell_spec("rl_r4.mixed256")["config"]}


def k(name, ts, dur):
    return {"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur}


def events():
    """A 1000 us span: kernels busy over [100, 300) and [500, 600) (one
    of them the leaf, 50 us), a host op covering the first idle gap."""
    return [
        {"ph": "X", "cat": "user_annotation", "name": trace.SPAN, "ts": 0,
         "dur": 1000},
        {"ph": "X", "cat": "user_annotation", "name": "portbench.merge",
         "ts": 0, "dur": 450},
        {"ph": "X", "cat": "cpu_op", "name": "aten::item", "ts": 5,
         "dur": 90},
        k("gemm", 100, 150), k("add", 200, 100),
        k("multicut_leaf_kernel<64>", 500, 50), k("copy", 550, 50),
        k("outside", 2000, 10)]


def test_reduce():
    s = trace.reduce(events())
    assert s["span_s"] == pytest.approx(1e-3)
    assert s["busy_s"] == pytest.approx(300e-6)
    assert len(s["kernels"]) == 4
    assert s["device_ops"][0] == ["gemm", pytest.approx(150e-6)]
    gaps = dict((n, d) for n, d in s["idle_gaps"])
    assert gaps["python"] == pytest.approx(400e-6)      # [600, 1000)
    assert gaps["merge/python"] == pytest.approx(200e-6)  # [300, 500)
    assert gaps["merge/aten::item"] == pytest.approx(100e-6)  # [0, 100)
    assert trace.reduce([e for e in events() if e["cat"] != "kernel"]) \
        is None


def ctx(driver):
    s = trace.reduce(events())
    base = {"config": CONFIG[driver], "trace": s, "height": 256,
            "width": 256, "cost": cost}
    if driver == "compress":
        base.update(driver="compress", timed_batches=4, traced_images=8,
                    traced_batches=2,
                    timings={"costs": 0.1, "solver": 0.2, "fallback": 0.3,
                             "merge": 0.4, "write": 0.5, "wire": 0.01})
    else:
        base.update(driver="rl", timed_steps=5, traced_steps=2,
                    batch_size=8, traced_solves=32,
                    timings={"forward": 0.05, "solve_reward": 0.25,
                             "update": 0.15})
    return base


def _span(count, host_s=0.0, device_s=None, syncs=0):
    return {"count": count, "host_s": host_s, "device_s": device_s,
            "syncs": syncs}


# what the program's profiling.snapshot() returns after a traced compress
# job of 2 batches and 5 traced RL steps, on a card
SNAPSHOT = {
    "spans": {"compress.batch": _span(2, 1.0, 0.8, syncs=78),
              "load": _span(2, 0.4), "write_wait": _span(2, 0.03),
              "rl.step": _span(5, 0.6, 0.5, syncs=125),
              "multicut": _span(5, 0.2, 0.125),
              "reward": _span(5, 0.4, 0.35)},
    "counters": {"merge.noop_images": 16}}
EMPTY = {"spans": {}, "counters": {}}

EXPECTED = {
    "costs_ms": 25.0, "solver_ms": 50.0, "fallback_ms": 75.0,
    "merge_ms": 100.0, "write_ms": 125.0,
    "rl_forward_ms": 10.0, "rl_solve_reward_ms": 50.0,
    "rl_update_ms": 30.0,
    "device_idle.compress": 70.0, "device_idle.train": 70.0,
    "kernels_per_batch.compress": 2.0,
    "leaf_roofline.compress": 100 * cost.leaf_bound_s(
        2048, 64, 2, 1)[0] / 50e-6,
    "leaf_roofline.train": 100 * cost.leaf_bound_s(
        32 * 256, 64, 2, 1)[0] / 50e-6,
    "compress_mfu": 100 * 8 * cost.unet_forward_flops(256, 256, 64)
    / 1e-3 / 989e12,
    "train_mfu": 100 * 2 * 4 * 8 * cost.unet_forward_flops(256, 256, 64)
    / 1e-3 / 989e12,
    "load_ms": 200.0, "write_wait_ms": 15.0, "merge_noop_images": 8.0,
    "syncs_per_batch.compress": 39.0,
    "rl_solve_ms": 25.0, "rl_reward_ms": 70.0, "syncs_per_step.train": 25.0,
}


@pytest.mark.parametrize("metric", [m for m in BENCH["per_layer"]],
                         ids=[m["name"] for m in BENCH["per_layer"]])
def test_reader(metric, monkeypatch):
    monkeypatch.setattr(profiling, "snapshot", lambda: SNAPSHOT)
    read = harness.reader(metric["name"])
    driver = ("rl" if metric["moves"] in ("steps_per_s", "step_p95_ms")
              else "compress")
    assert read(ctx(driver)) == pytest.approx(EXPECTED[metric["name"]])
    other = "compress" if driver == "rl" else "rl"
    assert read(ctx(other)) is None     # another driver's cell
    empty = dict(ctx(driver), trace=None, timings={})
    monkeypatch.setattr(profiling, "snapshot", lambda: EMPTY)
    assert read(empty) is None          # nothing to read: no number


def test_every_reader_has_an_expected_value():
    assert set(EXPECTED) == {m["name"] for m in BENCH["per_layer"]}
