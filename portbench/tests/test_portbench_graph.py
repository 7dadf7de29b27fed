"""The checkpoint-free graph cell (`graph.mixed256`, drivers/compress_graph):
the FH reference copies against the port, whole runs at a small size on the
CPU with the timed path broken underneath (`correct` must come out false
for each fault, true for the sound run), its control, its four readers on
a canned snapshot, and its files found by name."""

import json

import numpy as np
import pytest
import torch

from portbench import control_graph, harness
from portbench.reference import graph_based as ref_fh
from portbench.tests import tiny
from image_compression_torch.ops import graph_based as prog_fh
from image_compression_torch.utils import profiling

CELL = "graph.mixed256"
READERS = {"graph_rounds": "graph.rounds",
           "kept_images": "compress.kept_images",
           "merge_pairs": "merge.pairs",
           "guard_rewrites": "compress.guard_rewrites"}


@pytest.mark.parametrize("shape", [(64, 64), (48, 80), (12, 12)])
def test_fh_reference_equals_the_port(shape):
    """Seeded random images (smooth blobs and noise) at a tiled shape, a
    non-square one and one too small to tile: the reference's labels are
    the port's, bit for bit."""
    rng = np.random.default_rng(sum(shape))
    h, w = shape
    blobs = np.kron(rng.random((4, -(-h // 8), -(-w // 8), 3)),
                    np.ones((1, 8, 8, 1)))[:, :h, :w]
    x = torch.as_tensor((0.7 * blobs + 0.3 * rng.random((4, h, w, 3)))
                        .astype(np.float32))
    np.testing.assert_array_equal(ref_fh.felzenszwalb_labels(x).numpy(),
                                  prog_fh.felzenszwalb_labels(x).numpy())
    np.testing.assert_array_equal(ref_fh.graph_based_edge_costs(x).numpy(),
                                  prog_fh.graph_based_edge_costs(x).numpy())


def test_fh_reference_raises_on_other_settings():
    x = torch.zeros((1, 16, 16, 3))
    for kw in ({"sigma": 0.8}, {"k": 300.0}, {"min_size": 20}):
        with pytest.raises(ValueError):
            ref_fh.felzenszwalb_labels(x, **kw)


def _run(size=64, seed=4):
    torch.set_num_threads(2)
    return harness.run_cell(CELL, seed, 0.5, False, device="cpu",
                            spec=tiny.spec(CELL, size=size))


def test_sound_graph_run_is_correct():
    got = _run()
    assert got["correct"], got["checks"]


def _costs_altered(mp):
    """One edge of the first image's FH cost plane flipped."""
    from image_compression_torch import pipeline
    orig = pipeline.classical_costs_signed

    def flipped(images, target):
        costs = orig(images, target).clone()
        costs[0, 0, 0, 0] = -costs[0, 0, 0, 0]
        return costs
    mp.setattr(pipeline, "classical_costs_signed", flipped)


def _guard_missed(mp):
    """The guard never fires: over images stay sliced."""
    from image_compression_torch import pipeline
    mp.setattr(pipeline, "_passthrough_bytes", lambda src, c: 1 << 40)


def _guard_false(mp):
    """The guard fires on every kept slicing, those that fit too."""
    from image_compression_torch import pipeline
    mp.setattr(pipeline, "_passthrough_bytes", lambda src, c: 0)


@pytest.mark.parametrize("fault,size", [(_costs_altered, 64),
                                        (_guard_missed, 64),
                                        (_guard_false, 128)])
def test_graph_fault_is_not_correct(monkeypatch, fault, size):
    """At 64x64 every kept slicing of seed 4 is over its original + 49
    bytes (the guard rewrites it); at 128x128 some fit."""
    fault(monkeypatch)
    assert not _run(size)["correct"]


def test_control_fails_on_the_cpu():
    """At 128x128 (at 32x32 the bf16 rounding may move no edge)."""
    torch.set_num_threads(2)
    got = control_graph.control(CELL, 7, "cpu",
                                tiny.spec(CELL, images=8, size=128))
    assert not got["correct"] and got["numbers"]["costs_diff"][0] > 0, got


@pytest.mark.cuda
def test_control_fails_at_the_cells_size():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for seed in (2 ** 31 + 101, 2 ** 31 + 202, 2 ** 31 + 303):
        got = control_graph.control(CELL, seed, "cuda")
        assert not got["correct"], got


# the program's profiling.snapshot() after a traced graph job of 8 batches
SNAPSHOT = {"spans": {"compress.batch": {"count": 8, "host_s": 2.0,
                                         "device_s": 0.2, "syncs": 2966}},
            "counters": {"graph.rounds": 173, "compress.kept_images": 25,
                         "merge.pairs": 102, "compress.guard_rewrites": 13}}


@pytest.mark.parametrize("metric", sorted(READERS))
def test_reader(metric, monkeypatch):
    """Each reader: its counter over the batches in a compress cell, None in
    an RL cell, where the program counted nothing, and with a program
    without snapshot() (an older program)."""
    read = harness.reader(metric)
    monkeypatch.setattr(profiling, "snapshot", lambda: SNAPSHOT)
    assert read({"driver": "compress"}) == pytest.approx(
        SNAPSHOT["counters"][READERS[metric]] / 8)
    assert read({"driver": "rl"}) is None
    monkeypatch.setattr(profiling, "snapshot", lambda: dict(
        SNAPSHOT, counters={}))
    assert read({"driver": "compress"}) is None
    monkeypatch.delattr(profiling, "snapshot")
    assert read({"driver": "compress"}) is None


def test_manifest_holds_the_cell():
    """The configuration, the cell, its limits and its metrics as
    BENCHMARK.json names them; the cell's files found by name."""
    bench = harness.manifest()
    conf = {c["name"]: c for c in bench["configs"]}["graph_fh"]
    data = json.loads((harness.ROOT / conf["file"]).read_text())
    assert data["reduced"] == conf["reduced"] == [] == data["assumed"]
    assert data["graph"] == {"sigma": 1.0, "k": 100, "min_size": 250}
    assert data["settings"] == harness.cell_spec(
        "flagship.mixed1024")["config"]["settings"]
    spec = harness.cell_spec(CELL)
    assert spec["cell"]["chips"] == 1 and spec["traffic"]["size"] == 256
    assert (harness.HERE / "drivers" / "compress_graph.py").is_file()
    assert set(spec["limits"]) == {"costs_diff", "input_mismatch",
                                   "solver_diff", "partition_diff",
                                   "lossless_fail", "over_bound"}
    assert not any(spec["limits"].values())
    assert {m["name"] for m in spec["end_to_end"]} == {
        "images_per_s", "out_orig", "setup_s"}
    names = {m["name"] for m in spec["per_layer"]}
    assert names >= set(READERS) and "compress_mfu" not in names
    for m in spec["per_layer"]:
        assert callable(harness.reader(m["name"]))
        assert m["moves"] == "images_per_s"
