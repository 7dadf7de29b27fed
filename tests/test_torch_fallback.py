"""Fallback decision of the PyTorch port vs the JAX reference: the same keep
masks on the fixtures of tests/test_fallback.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_compression_tpu.pipeline import (
    fallback_single_slice as j_fallback)
from image_compression_torch.pipeline import fallback_single_slice

torch.set_num_threads(1)


def _block_minlabel(h, w, bs):
    ys, xs = np.mgrid[:h, :w]
    return ((ys // bs * bs) * w + (xs // bs * bs)).astype(np.int32)


def _fallback_fixture():
    rng = np.random.default_rng(0)
    ys, xs = np.mgrid[:64, :64]
    grad = ((ys + xs) / 126.0)[..., None].repeat(3, -1).astype(np.float32)
    noise = rng.random((64, 64, 3)).astype(np.float32)
    images = np.stack([grad, noise])
    labels = np.stack([_block_minlabel(64, 64, 16)] * 2)
    return images, labels


@pytest.mark.parametrize("margin", [0.0, 1.0, 1e9])
@pytest.mark.parametrize("zero_labels", [False, True])
def test_fallback_same_decisions(margin, zero_labels):
    images, labels = _fallback_fixture()
    if zero_labels:
        labels = np.zeros_like(labels)
    ref = np.asarray(j_fallback(jnp.asarray(images), jnp.asarray(labels),
                                margin, k_max=16))
    got = fallback_single_slice(torch.as_tensor(images),
                                torch.as_tensor(labels), margin, k_max=16)
    np.testing.assert_array_equal(ref, got.numpy())


def test_fallback_product_profile_with_orig_sizes():
    """The shipped estimator profile, with the sources' byte sizes as the
    whole-image floor."""
    images, labels = _fallback_fixture()
    kw = dict(k_max=16, entropy_correction="miller_madow",
              literal_hist="nonmatch", overhead_base=68.0,
              distance_window=32768)
    sizes = np.asarray([900.0, 20000.0], np.float32)
    ref = np.asarray(j_fallback(jnp.asarray(images), jnp.asarray(labels),
                                1.0, orig_sizes=jnp.asarray(sizes), **kw))
    got = fallback_single_slice(torch.as_tensor(images),
                                torch.as_tensor(labels), 1.0,
                                orig_sizes=torch.as_tensor(sizes), **kw)
    np.testing.assert_array_equal(ref, got.numpy())
