"""The readers of the program's own spans and counters (`program.py` and
the metrics that use it) on snapshots that the program's tracing module
fills through its own `span`, `count_device` and `snapshot`: each reads
its number in its driver's cell and None in the other's; the device-time
and sync readers read None off the card."""

import time

import pytest
import torch

from portbench import harness, program
from image_compression_torch.utils import profiling
from image_compression_torch.utils.profiling import count_device, span

COMPRESS = ("load_ms", "write_wait_ms", "merge_noop_images",
            "syncs_per_batch.compress")
RL = ("rl_solve_ms", "rl_reward_ms", "syncs_per_step.train")


@pytest.fixture(autouse=True)
def fresh():
    profiling.reset()
    yield
    profiling.reset()


def _compress(batches=2):
    """A compress job's spans: per batch a load of ~2 ms, a merge that
    counts 8 one-region images, and a wait for the write."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity
                                            .CPU]):
        for b in range(batches):
            with span("compress.batch", "cpu", id=b):
                with span("load"):
                    time.sleep(0.002)
                with span("merge", "cpu"):
                    count_device("merge.noop_images",
                                 torch.tensor(8, dtype=torch.int64))
            with span("write_wait", id=b):
                time.sleep(0.001)


def _rl(steps=3):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity
                                            .CPU]):
        for s in range(steps):
            with span("rl.step", "cpu", id=s):
                with span("solve_reward", "cpu"):
                    for name in ("sample", "multicut", "reward"):
                        with span(name, "cpu"):
                            torch.ones(16).sum()


def _read(metric, driver):
    return harness.reader(metric)({"driver": driver})


def test_manifest_names_every_reader():
    names = {m["name"]: m for m in harness.manifest()["per_layer"]}
    for metric in COMPRESS + RL:
        assert names[metric]["source"] in ("program_span", "program_counter")
        assert names[metric]["workloads"] == (
            ["flagship.mixed1024"] if metric in COMPRESS
            else ["rl_r4.mixed256"])


def test_compress_readers_on_the_programs_spans():
    _compress()
    spans = profiling.snapshot()["spans"]
    assert _read("load_ms", "compress") == pytest.approx(
        1e3 * spans["load"]["host_s"] / 2)
    assert _read("load_ms", "compress") >= 2.0
    assert _read("write_wait_ms", "compress") == pytest.approx(
        1e3 * spans["write_wait"]["host_s"] / 2)
    assert _read("merge_noop_images", "compress") == 8.0
    # no CUDA events: no device, so no syncs are counted
    assert _read("syncs_per_batch.compress", "compress") is None
    for metric in COMPRESS:
        assert _read(metric, "rl") is None


def test_rl_readers_read_nothing_off_the_card():
    _rl()
    for metric in RL:
        assert _read(metric, "rl") is None
        assert _read(metric, "compress") is None


def test_readers_on_device_times_and_syncs(monkeypatch):
    """The program's snapshot with the device's numbers put in (device
    seconds of 1, 2 and 3 ms a span, syncs): each reader's arithmetic."""
    _rl()
    _compress()
    real = profiling.snapshot

    def on_card():
        snap = real()
        for name, s in snap["spans"].items():
            s["device_s"] = {"multicut": 0.003, "reward": 0.002}.get(name,
                                                                      0.001)
        snap["spans"]["rl.step"]["syncs"] = 30
        snap["spans"]["compress.batch"]["syncs"] = 14
        return snap

    monkeypatch.setattr(profiling, "snapshot", on_card)
    assert _read("rl_solve_ms", "rl") == pytest.approx(1.0)
    assert _read("rl_reward_ms", "rl") == pytest.approx(2 / 3)
    assert _read("syncs_per_step.train", "rl") == 10.0
    assert _read("syncs_per_batch.compress", "compress") == 7.0


def test_nothing_recorded_reads_none(monkeypatch):
    """An empty snapshot, or a program without snapshot() (an older
    program), gives every reader None."""
    for metric in COMPRESS + RL:
        driver = "compress" if metric in COMPRESS else "rl"
        assert _read(metric, driver) is None
    monkeypatch.delattr(profiling, "snapshot")
    assert program.per_unit({"driver": "compress"}, "compress") is None


@pytest.mark.cuda
def test_rl_readers_on_card():
    """On a card the device-time readers read the spans' CUDA events."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: device time exists only on the card")
    dev = torch.device("cuda")
    x = torch.ones(1 << 20, device=dev)
    with torch.profiler.profile():
        for s in range(2):
            with span("rl.step", dev, id=s):
                with span("multicut", dev):
                    (x * 2).sum()
                with span("reward", dev):
                    x.nonzero()
    assert _read("rl_solve_ms", "rl") > 0
    assert _read("rl_reward_ms", "rl") > 0
    assert _read("syncs_per_step.train", "rl") == 1.0
