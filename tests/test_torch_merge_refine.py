"""Merge refinement of the PyTorch port vs the JAX reference: the same
labels on the fixtures of tests/test_merge_refine.py, with the one-region
(declined) image anywhere in the batch or absent, and batches of one-region
images returned without a round."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_compression_tpu.ops.merge_refine import (
    merge_refine_batch as j_merge)
from image_compression_torch.ops import merge_refine as mr
from image_compression_torch.ops.merge_refine import merge_refine_batch

torch.set_num_threads(1)


def _block_minlabel(h, w, bs):
    ys, xs = np.mgrid[:h, :w]
    return ((ys // bs * bs) * w + (xs // bs * bs)).astype(np.int32)


def _merge_fixtures():
    rng = np.random.default_rng(0)
    split = np.zeros((64, 64, 3), np.float32)
    split[:, :32] = rng.normal(0.3, 0.02, (64, 32, 3))
    split[:, 32:] = rng.normal(0.75, 0.25, (64, 32, 3))
    lab_split = np.zeros((64, 64), np.int32)
    lab_split[32:, :32] = 32 * 64
    lab_split[:, 32:] = 32
    texture = np.clip(rng.normal(0.5, 0.03, (64, 64, 3)), 0, 1)
    quads = np.zeros((64, 64), np.int32)
    quads[:32, 32:] = 32
    quads[32:, :32] = 32 * 64
    quads[32:, 32:] = 32 * 64 + 32
    mosaic = np.zeros((64, 64, 3), np.float32)
    mosaic[:32, :32] = rng.normal(0.2, 0.01, (32, 32, 3))
    mosaic[:32, 32:] = rng.normal(0.8, 0.30, (32, 32, 3))
    mosaic[32:, :32] = rng.normal(0.5, 0.10, (32, 32, 3))
    mosaic[32:, 32:] = rng.normal(0.35, 0.45, (32, 32, 3))
    noise = rng.random((64, 64, 3))
    small = np.clip(rng.normal(0.5, 0.05, (64, 64, 3)), 0, 1)
    images = np.clip(np.stack([split, texture, mosaic, noise, small]), 0,
                     1).astype(np.float32)
    labels = np.stack([lab_split, quads, quads, np.zeros((64, 64), np.int32),
                       _block_minlabel(64, 64, 8)])
    return images, labels


@pytest.mark.parametrize("k_max,rounds,max_pairs",
                         [(8, 2, 4), (64, 2, 32)])
def test_merge_same_labels(k_max, rounds, max_pairs):
    """Artificial split merged, real boundary kept, 4-way merge over two
    rounds, distinct mosaic untouched, declined image a no-op, and an
    overflowing 64-block partition (clamp bucket never merged)."""
    images, labels = _merge_fixtures()
    kw = dict(k_max=k_max, rounds=rounds, max_pairs=max_pairs)
    ref = np.asarray(j_merge(jnp.asarray(images), jnp.asarray(labels), **kw))
    got = merge_refine_batch(torch.as_tensor(images),
                             torch.as_tensor(labels), **kw)
    np.testing.assert_array_equal(ref, got.numpy())
    assert (got[3] == 0).all()  # declined image stays one region


def _spy_rounds(monkeypatch):
    """The labels each merge round receives, in call order."""
    seen = []
    real = mr._merge_round

    def spy(imgs, labels, **kw):
        seen.append(labels)
        return real(imgs, labels, **kw)

    monkeypatch.setattr(mr, "_merge_round", spy)
    return seen


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("value", [0, 7])
def test_one_region_batch_unchanged(monkeypatch, value, dtype):
    """A batch of one-region images (declined: all zero; or any constant
    label) comes back as it is, without segment stats or an estimate."""
    def never(*args, **kwargs):
        raise AssertionError("merge rounds ran on one-region images")

    monkeypatch.setattr(mr, "segment_stats", never)
    monkeypatch.setattr(mr, "estimate_segment_png_sizes_fast", never)
    images = torch.rand((3, 16, 24, 3),
                        generator=torch.Generator().manual_seed(0))
    labels = torch.full((3, 16, 24), value, dtype=dtype)
    got = merge_refine_batch(images, labels)
    assert got.dtype == dtype
    assert torch.equal(got, labels)


@pytest.mark.parametrize("k_max,rounds,max_pairs",
                         [(8, 2, 4), (64, 2, 32)])
@pytest.mark.parametrize("declined_at", [0, 2, 4])
def test_merge_mixed_batch(monkeypatch, declined_at, k_max, rounds,
                           max_pairs):
    """The declined image first, in the middle or last: the rounds run on
    the four multi-region images only, the batch equals the reference's,
    and each image equals itself merged alone."""
    images, labels = _merge_fixtures()
    multi = [0, 1, 2, 4]
    order = multi[:declined_at] + [3] + multi[declined_at:]
    images, labels = images[order], labels[order]
    kw = dict(k_max=k_max, rounds=rounds, max_pairs=max_pairs)
    ref = np.asarray(j_merge(jnp.asarray(images), jnp.asarray(labels), **kw))
    seen = _spy_rounds(monkeypatch)
    got = merge_refine_batch(torch.as_tensor(images),
                             torch.as_tensor(labels), **kw).numpy()
    assert [s.shape[0] for s in seen] == [len(multi)] * rounds
    np.testing.assert_array_equal(ref, got)
    assert (got[declined_at] == 0).all()
    for i in range(len(order)):
        alone = merge_refine_batch(torch.as_tensor(images[i:i + 1]),
                                   torch.as_tensor(labels[i:i + 1]), **kw)
        np.testing.assert_array_equal(got[i], alone[0].numpy())


@pytest.mark.parametrize("k_max,rounds,max_pairs",
                         [(8, 2, 4), (64, 2, 32)])
def test_merge_all_multi_region(monkeypatch, k_max, rounds, max_pairs):
    """No image declined: the first round receives the input labels
    themselves (no sub-batch), and the batch equals the reference's."""
    images, labels = _merge_fixtures()
    # five images, as in the other cases (the reference's trace is reused)
    order = [0, 1, 2, 4, 1]
    images, labels = images[order], labels[order]
    kw = dict(k_max=k_max, rounds=rounds, max_pairs=max_pairs)
    ref = np.asarray(j_merge(jnp.asarray(images), jnp.asarray(labels), **kw))
    seen = _spy_rounds(monkeypatch)
    labels_t = torch.as_tensor(labels)
    got = merge_refine_batch(torch.as_tensor(images), labels_t, **kw)
    assert len(seen) == rounds and seen[0] is labels_t
    np.testing.assert_array_equal(ref, got.numpy())
