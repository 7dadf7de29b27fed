"""Merge refinement of the PyTorch port vs the JAX reference: the same
labels on the fixtures of tests/test_merge_refine.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_compression_tpu.ops.merge_refine import (
    merge_refine_batch as j_merge)
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
