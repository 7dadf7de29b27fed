"""The whole compress slice of the PyTorch port vs the JAX reference
(hier_agg="matrix", shipped settings otherwise) on 64x64 images: identical
labels and connectivity bits, identical metadata.bin, identical decoded
slice pixels (the PNG encoders differ, so bytes are not compared), and a
lossless reassembly.

Both sides get the same cost planes — signed edges of a fixed partition per
image — so the comparison covers solver, fallback decision, merge
refinement, wire and writer; the U-Net is compared separately
(tests/test_torch_unet.py)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from image_compression_tpu import pipeline as jp
from image_compression_tpu.config import Config as JConfig
from image_compression_tpu.ops import edges as je
from image_compression_torch import pipeline as tp
from image_compression_torch.config import Config
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


def test_metadata_and_slice_pixels(runs):
    _, _, _, j_dirs, t_dirs = runs
    for jd, td in zip(j_dirs, t_dirs):
        assert (td / "metadata.bin").read_bytes() == \
            (jd / "metadata.bin").read_bytes()
        names = sorted(p.name for p in jd.glob("slice_*.png"))
        assert names == sorted(p.name for p in td.glob("slice_*.png"))
        for name in names:
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
    """Labels, wire bits, metadata.bin bytes and decoded slice pixels equal
    the reference's, and the slices reassemble losslessly."""
    img, j_labels, t_labels, j_wire, t_wire, jd, td = wide_run
    np.testing.assert_array_equal(j_labels, t_labels)
    for ref, got in zip(j_wire, t_wire):
        np.testing.assert_array_equal(ref, got)
    assert (td / "metadata.bin").read_bytes() == \
        (jd / "metadata.bin").read_bytes()
    names = sorted(p.name for p in jd.glob("slice_*.png"))
    assert names == sorted(p.name for p in td.glob("slice_*.png"))
    assert len(names) > 1  # the slicing was kept
    for name in names:
        np.testing.assert_array_equal(load_image(td / name),
                                      load_image(jd / name))
    np.testing.assert_array_equal(reassemble_array(td), ensure_rgba(img))
