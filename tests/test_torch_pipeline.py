"""The whole compress slice of the PyTorch port vs the JAX reference
(hier_agg="matrix", shipped settings otherwise) on 64x64 images: identical
labels and connectivity bits, identical metadata.bin and slice PNG bytes,
and a lossless reassembly.

The learned-cost cases give both sides the same cost planes — signed edges
of a fixed partition per image — so the comparison covers solver, fallback
decision, merge refinement, wire and writer; the U-Net is compared
separately (tests/test_torch_unet.py). The classical cases run both
sides' compress_directory end to end (canny and graph costs, slice files
and packs), and a three-batch run, whose host and device halves overlap,
against a one-batch run."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from image_compression_tpu import pipeline as jp
from image_compression_tpu.config import Config as JConfig
from image_compression_tpu.config import EdgeTarget as JEdgeTarget
from image_compression_tpu.ops import edges as je
from image_compression_torch import pipeline as tp
from image_compression_torch.config import Config, EdgeTarget
from image_compression_torch.io import pypng
from image_compression_torch.io.image_io import ensure_rgba, load_image
from image_compression_torch.io.reassemble import reassemble_array
from image_compression_torch.ops import edges as te

torch.set_num_threads(1)

H = W = 64


def _fixture():
    """Five images with their partitions: noise|flat halves, the same with
    the noise split, noise|stripes, low|high noise (all fall back), and four
    distinct quadrants (kept; merge refinement merges a pair)."""
    rng = np.random.default_rng(0)
    halves = np.zeros((H, W), np.int64)
    halves[:, 32:] = 1
    split = halves.copy()
    split[32:, :32] = 2
    quads = np.zeros((H, W), np.int64)
    quads[:32, 32:] = 1
    quads[32:, :32] = 2
    quads[32:, 32:] = 3
    img0 = np.zeros((H, W, 3), np.uint8)
    img0[:, :32] = rng.integers(0, 256, (H, 32, 3))
    img0[:, 32:] = (30, 60, 90)
    img2 = np.zeros((H, W, 3), np.uint8)
    img2[:, :32] = rng.integers(0, 256, (H, 32, 3))
    img2[:, 32:] = np.tile(rng.integers(0, 256, (1, 32, 3)), (H, 1, 1))
    img3 = np.zeros((H, W, 3), np.uint8)
    img3[:, :32] = rng.integers(0, 64, (H, 32, 3))
    img3[:, 32:] = rng.integers(192, 256, (H, 32, 3))
    img4 = np.zeros((H, W, 3), np.uint8)
    img4[:32, :32] = rng.integers(0, 16, (32, 32, 3))
    img4[:32, 32:] = (200, 0, 0)
    img4[32:, :32] = rng.integers(100, 256, (32, 32, 3))
    img4[32:, 32:] = np.tile(np.arange(32, dtype=np.uint8)[None, :, None] * 8,
                             (32, 1, 3))
    images = [img0, img0.copy(), img2, img3, img4]
    parts = np.stack([halves, split, halves, halves, quads])
    return images, parts


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    images, parts = _fixture()
    names = [f"im{i}" for i in range(len(images))]
    out = tmp_path_factory.mktemp("slice")
    j_parts = jnp.asarray(parts)
    t_parts = torch.as_tensor(parts)

    def j_cost(_batch):
        return (2.0 * je.edges_from_labels(j_parts) - 1.0) * \
            je.edge_validity_masks(H, W)

    def t_cost(batch):
        return (2.0 * te.edges_from_labels(t_parts) - 1.0) * \
            te.edge_validity_masks(H, W, device=batch.device)

    jcfg = JConfig()
    jcfg.multicut.hier_agg = "matrix"
    cfg = Config()
    j_wire = jax.tree.map(np.asarray, jp._device_wire(images, j_cost, jcfg))
    j_dirs = jp._write_batch(images, j_wire, jcfg, out / "j", names)
    with torch.inference_mode():
        labels = tp._device_labels(images, t_cost, cfg, torch.device("cpu"))
    t_wire = tp._pack_wire(labels)
    t_dirs = tp.compress_arrays(images, t_cost, cfg, out / "t", names,
                                device="cpu")
    return images, j_wire, t_wire, j_dirs, t_dirs


def test_connectivity_bits_and_single_flags(runs):
    _, j_wire, t_wire, _, _ = runs
    for ref, got in zip(j_wire, t_wire):
        np.testing.assert_array_equal(ref, got)
    assert not t_wire[2].all() and t_wire[2].any()  # some kept, some not


def _assert_same_files(td, jd):
    """Same file names, each byte-equal (slice PNGs and metadata.bin)."""
    names = sorted(p.name for p in jd.iterdir())
    assert names == sorted(p.name for p in td.iterdir())
    assert "metadata.bin" in names
    for name in names:
        assert (td / name).read_bytes() == (jd / name).read_bytes(), name


def test_metadata_and_slice_pixels(runs):
    """metadata.bin and every slice PNG byte-equal (so the decoded pixels
    are too)."""
    _, _, _, j_dirs, t_dirs = runs
    for jd, td in zip(j_dirs, t_dirs):
        _assert_same_files(td, jd)
        for name in (p.name for p in jd.glob("slice_*.png")):
            np.testing.assert_array_equal(load_image(td / name),
                                          load_image(jd / name))


def test_reassembly_lossless(runs):
    images, _, _, _, t_dirs = runs
    assert len(list(t_dirs[4].glob("slice_*.png"))) == 3  # kept and merged
    for img, d in zip(images, t_dirs):
        np.testing.assert_array_equal(reassemble_array(d), ensure_rgba(img))


@pytest.fixture(scope="module")
def wide_run(tmp_path_factory):
    """One non-square 48x80 image (three vertical bands: low noise, flat,
    high noise) through both pipelines; its top supertile is 16, so the
    solver finishes with the sorted rounds."""
    h, w = 48, 80
    rng = np.random.default_rng(7)
    part = np.zeros((1, h, w), np.int64)
    part[:, :, 24:56] = 1
    part[:, :, 56:] = 2
    img = np.zeros((h, w, 3), np.uint8)
    img[:, :24] = rng.integers(0, 16, (h, 24, 3))
    img[:, 24:56] = (200, 0, 0)
    img[:, 56:] = rng.integers(100, 256, (h, 24, 3))
    out = tmp_path_factory.mktemp("wide")

    def j_cost(_batch):
        return (2.0 * je.edges_from_labels(jnp.asarray(part)) - 1.0) * \
            je.edge_validity_masks(h, w)

    def t_cost(batch):
        return (2.0 * te.edges_from_labels(torch.as_tensor(part)) - 1.0) * \
            te.edge_validity_masks(h, w, device=batch.device)

    jcfg = JConfig()
    jcfg.multicut.hier_agg = "matrix"
    cfg = Config()
    j_labels = np.asarray(jp._device_labels([img], j_cost, jcfg))
    j_wire = jax.tree.map(np.asarray, jp._pack_wire(jnp.asarray(j_labels)))
    j_dirs = jp._write_batch([img], j_wire, jcfg, out / "j", ["wide"])
    with torch.inference_mode():
        labels = tp._device_labels([img], t_cost, cfg, torch.device("cpu"))
    t_dirs = tp.compress_arrays([img], t_cost, cfg, out / "t", ["wide"],
                                device="cpu")
    return img, j_labels, labels.numpy(), j_wire, tp._pack_wire(labels), \
        j_dirs[0], t_dirs[0]


def test_non_square_image_matches_reference(wide_run):
    """Labels, wire bits, metadata.bin and slice PNG bytes equal the
    reference's, and the slices reassemble losslessly."""
    img, j_labels, t_labels, j_wire, t_wire, jd, td = wide_run
    np.testing.assert_array_equal(j_labels, t_labels)
    for ref, got in zip(j_wire, t_wire):
        np.testing.assert_array_equal(ref, got)
    _assert_same_files(td, jd)
    names = sorted(p.name for p in jd.glob("slice_*.png"))
    assert len(names) > 1  # the slicing was kept
    for name in names:
        np.testing.assert_array_equal(load_image(td / name),
                                      load_image(jd / name))
    np.testing.assert_array_equal(reassemble_array(td), ensure_rgba(img))


@pytest.fixture(scope="module")
def tiny_runs(tmp_path_factory):
    """Two 12x12 images (sides under 16: the tiny-grid ensemble) through
    both pipelines, once at the shipped settings and once with the fallback
    and merge refinement off, so that the solver's partition reaches the
    slicer and the writer."""
    h = w = 12
    rng = np.random.default_rng(9)
    parts = np.zeros((2, h, w), np.int64)
    parts[0, :, 6:] = 1
    parts[1, 5:, :] = 1
    parts[1, 5:, 8:] = 2
    img0 = np.zeros((h, w, 3), np.uint8)
    img0[:, :6] = rng.integers(0, 256, (h, 6, 3))
    img0[:, 6:] = (10, 200, 30)
    img1 = np.zeros((h, w, 3), np.uint8)
    img1[:5] = (250, 250, 250)
    img1[5:, :8] = rng.integers(0, 256, (h - 5, 8, 3))
    img1[5:, 8:] = (0, 0, 90)
    images = [img0, img1]
    names = ["tiny0", "tiny1"]
    out = tmp_path_factory.mktemp("tiny")

    def j_cost(_batch):
        return (2.0 * je.edges_from_labels(jnp.asarray(parts)) - 1.0) * \
            je.edge_validity_masks(h, w)

    def t_cost(batch):
        return (2.0 * te.edges_from_labels(torch.as_tensor(parts)) - 1.0) * \
            te.edge_validity_masks(h, w, device=batch.device)

    results = []
    for k, overrides in enumerate(
            [{}, dict(compress_fallback=False, merge_refine_rounds=0)]):
        jcfg = JConfig()
        jcfg.multicut.hier_agg = "matrix"
        cfg = Config()
        for key, val in overrides.items():
            setattr(jcfg, key, val)
            setattr(cfg, key, val)
        j_labels = np.asarray(jp._device_labels(images, j_cost, jcfg))
        j_wire = jax.tree.map(np.asarray,
                              jp._pack_wire(jnp.asarray(j_labels)))
        j_dirs = jp._write_batch(images, j_wire, jcfg, out / f"j{k}", names)
        with torch.inference_mode():
            labels = tp._device_labels(images, t_cost, cfg,
                                       torch.device("cpu"))
        t_dirs = tp.compress_arrays(images, t_cost, cfg, out / f"t{k}",
                                    names, device="cpu")
        results.append((j_labels, labels.numpy(), j_wire,
                        tp._pack_wire(labels), j_dirs, t_dirs))
    return images, results


def test_tiny_image_matches_reference(tiny_runs):
    """12x12: labels, wire bits, metadata.bin and slice PNG bytes equal the
    reference's in both runs, the slices reassemble losslessly,
    and without the fallback the solver's regions are written as several
    slices."""
    images, results = tiny_runs
    for k, (j_labels, t_labels, j_wire, t_wire, j_dirs, t_dirs) in \
            enumerate(results):
        np.testing.assert_array_equal(j_labels, t_labels)
        for ref, got in zip(j_wire, t_wire):
            np.testing.assert_array_equal(ref, got)
        for img, jd, td in zip(images, j_dirs, t_dirs):
            _assert_same_files(td, jd)
            names = sorted(p.name for p in jd.glob("slice_*.png"))
            assert names == sorted(p.name for p in td.glob("slice_*.png"))
            for name in names:
                np.testing.assert_array_equal(load_image(td / name),
                                              load_image(jd / name))
            np.testing.assert_array_equal(reassemble_array(td),
                                          ensure_rgba(img))
        if k == 1:  # three sorted rounds from singletons: partial merges
            assert all(len(list(d.glob("slice_*.png"))) > 1 for d in t_dirs)


@pytest.fixture(scope="module")
def classical_runs(tmp_path_factory):
    """The five fixture images as PNG files through both sides'
    compress_directory with canny and graph costs, as slice files and as
    packs (one batch of five), and with canny and the fallback off (every
    image sliced); plus both sides' device labels and wire."""
    images, _ = _fixture()
    root = tmp_path_factory.mktemp("classical")
    data = root / "data"
    data.mkdir()
    for i, img in enumerate(images):
        (data / f"im{i}.png").write_bytes(pypng.encode(img))
    sizes = [(data / f"im{i}.png").stat().st_size for i in range(5)]
    out = {}
    for target in ("canny", "graph"):
        jcfg = JConfig()  # the reference's shipped compress settings
        cfg = Config()
        j_labels = np.asarray(jp._device_labels(
            images, lambda b: jp.classical_costs_signed(
                b, JEdgeTarget(target)), jcfg, orig_sizes=sizes))
        with torch.inference_mode():
            t_labels = tp._device_labels(
                images, lambda b: tp.classical_costs_signed(
                    b, EdgeTarget(target)), cfg, torch.device("cpu"),
                orig_sizes=sizes)
        out[target, "labels"] = (j_labels, t_labels.numpy(),
                                 jax.tree.map(np.asarray, jp._pack_wire(
                                     jnp.asarray(j_labels))),
                                 tp._pack_wire(t_labels))
        runs = [("files", True), ("pack", True)]
        if target == "canny":
            runs.append(("files", False))
        for container, fallback in runs:
            key = f"{target}_{container}_{fallback}"
            jcfg = JConfig(dataset_dir=str(data),
                           results_dir=str(root / f"j_{key}"),
                           slice_container=container,
                           compress_fallback=fallback)
            cfg = Config(dataset_dir=str(data),
                         results_dir=str(root / f"t_{key}"),
                         slice_container=container,
                         compress_fallback=fallback)
            out[target, container, fallback] = (
                jp.compress_directory(jcfg,
                                      classical=JEdgeTarget(target)),
                tp.compress_directory(cfg, classical=EdgeTarget(target),
                                      device="cpu"))
    return images, data, out


@pytest.mark.parametrize("target", ["canny", "graph"])
def test_classical_labels_and_wire_match_reference(classical_runs, target):
    _, _, out = classical_runs
    j_labels, t_labels, j_wire, t_wire = out[target, "labels"]
    np.testing.assert_array_equal(t_labels, j_labels)
    for ref, got in zip(j_wire, t_wire):
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("target,container,fallback", [
    ("canny", "files", True), ("canny", "pack", True),
    ("canny", "files", False), ("graph", "files", True),
    ("graph", "pack", True)])
def test_classical_compress_directory_bytes(classical_runs, target,
                                            container, fallback):
    """Slice PNGs, metadata.bin and packs byte-equal to the reference's
    compress_directory(classical=...); every output reassembles
    losslessly; with graph costs, or without the fallback, some image
    keeps a slicing."""
    images, _, out = classical_runs
    j_out, t_out = out[target, container, fallback]
    assert [p.name for p in t_out] == [p.name for p in j_out]
    kept = 0
    for img, jd, td in zip(images, j_out, t_out):
        if container == "pack":
            assert td.read_bytes() == jd.read_bytes()
        else:
            _assert_same_files(td, jd)
            kept += len(list(td.glob("slice_*.png"))) > 1
        np.testing.assert_array_equal(reassemble_array(td), ensure_rgba(img))
    if container == "files" and (target == "graph" or not fallback):
        assert kept >= 1


def test_overlapped_batches_equal_one_batch(classical_runs, tmp_path):
    """Three batches of two (the host writes batch i while batch i + 1's
    device half runs) give the bytes of the one-batch run."""
    _, data, out = classical_runs
    cfg = Config(dataset_dir=str(data), results_dir=str(tmp_path))
    timings: dict = {}
    dirs = tp.compress_directory(cfg, classical=EdgeTarget.GRAPH,
                                 batch_size=2, device="cpu", timings=timings)
    _, one_batch = out["graph", "files", True]
    assert [d.name for d in dirs] == [d.name for d in one_batch]
    for td, od in zip(dirs, one_batch):
        _assert_same_files(td, od)
    assert set(timings) == {"costs", "solver", "fallback", "merge", "wire",
                            "write"}


def test_write_failure_raises_in_the_caller(classical_runs, tmp_path):
    """A batch whose write fails in the worker thread raises from
    compress_directory."""
    _, data, _ = classical_runs
    blocker = tmp_path / "results"
    blocker.write_bytes(b"a file where the results directory should be")
    cfg = Config(dataset_dir=str(data), results_dir=str(blocker))
    with pytest.raises(OSError):
        tp.compress_directory(cfg, batch_size=2, device="cpu")
