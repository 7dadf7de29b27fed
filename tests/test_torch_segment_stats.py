"""Segment statistics of the PyTorch port vs the JAX reference: bitwise,
including the k_max overflow clamp, num_segments and overflow."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_compression_tpu.ops import segment_stats as js
from image_compression_torch.ops import segment_stats as ts

torch.set_num_threads(1)


def _blocks(h, w, bs):
    ys, xs = np.mgrid[:h, :w]
    return ((ys // bs * bs) * w + (xs // bs * bs)).astype(np.int32)


def _labels():
    rng = np.random.default_rng(1)
    return np.stack([_blocks(32, 32, 8), _blocks(32, 32, 4),
                     rng.integers(0, 50, (32, 32)).astype(np.int32),
                     np.zeros((32, 32), np.int32),
                     (rng.integers(-5, 5, (32, 32)) * 1000).astype(np.int32)])


@pytest.mark.parametrize("k_max", [8, 16, 64, 70])
@pytest.mark.parametrize("fn", ["segment_stats", "segment_stats_minlabel"])
def test_stats_bitwise(fn, k_max):
    labels = _labels()
    got = getattr(ts, fn)(torch.as_tensor(labels), k_max)
    for i in range(len(labels)):
        ref = getattr(js, fn)(jnp.asarray(labels[i]), k_max)
        for field in ref._fields:
            np.testing.assert_array_equal(np.asarray(getattr(ref, field)),
                                          getattr(got, field)[i].numpy(),
                                          err_msg=f"{i} {field}")


@pytest.mark.parametrize("slots", [8, 16, 80])
def test_dense_ranks_bitwise(slots):
    labels = _labels()
    got = ts.dense_ranks(torch.as_tensor(labels), slots)
    for i in range(len(labels)):
        np.testing.assert_array_equal(
            np.asarray(js.dense_ranks(jnp.asarray(labels[i]), slots)),
            got[i].numpy())


def test_minlabel_rejects_large_k():
    with pytest.raises(ValueError, match="256"):
        ts.segment_stats_minlabel(torch.zeros((1, 4, 4), dtype=torch.int32),
                                  300)
