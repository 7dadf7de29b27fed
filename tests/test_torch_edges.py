"""Edge-plane helpers of the PyTorch port vs the JAX reference: bitwise,
except the two squashes, whose tanh/exp are XLA's and PyTorch's own
approximations and differ by a few ulp (up to 4 measured on tanh): held
to an absolute 1e-6 on values of magnitude <= 2."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_compression_tpu.ops import edges as je
from image_compression_torch.ops import edges as te

torch.set_num_threads(1)


@pytest.mark.parametrize("shape", [(5, 7), (16, 16), (1, 4)])
def test_masks_and_edge_count(shape):
    np.testing.assert_array_equal(np.asarray(je.edge_validity_masks(*shape)),
                                  te.edge_validity_masks(*shape).numpy())
    assert te.num_grid_edges(*shape) == je.num_grid_edges(*shape)


def test_edges_from_labels_and_flatten_roundtrip():
    rng = np.random.default_rng(0)
    labels = rng.integers(0, 3, size=(2, 6, 9)).astype(np.int32)
    ref = np.asarray(je.edges_from_labels(jnp.asarray(labels)))
    got = te.edges_from_labels(torch.as_tensor(labels))
    np.testing.assert_array_equal(ref, got.numpy())
    flat_ref = np.asarray(je.flatten_edge_planes(jnp.asarray(ref)))
    flat = te.flatten_edge_planes(got)
    np.testing.assert_array_equal(flat_ref, flat.numpy())
    np.testing.assert_array_equal(
        np.asarray(je.unflatten_edge_planes(jnp.asarray(flat_ref), 6, 9)),
        te.unflatten_edge_planes(flat, 6, 9).numpy())


def test_model_output_squashes():
    rng = np.random.default_rng(1)
    out = rng.normal(size=(2, 4, 5, 4)).astype(np.float32) * 3
    mu_r, sg_r = je.split_model_output(jnp.asarray(out))
    mu, sg = te.split_model_output(torch.as_tensor(out))
    np.testing.assert_array_equal(np.asarray(mu_r), mu.numpy())
    np.testing.assert_array_equal(np.asarray(sg_r), sg.numpy())
    np.testing.assert_allclose(np.asarray(je.squash_mu(mu_r)),
                               te.squash_mu(mu).numpy(), rtol=0, atol=1e-6)
    np.testing.assert_allclose(np.asarray(je.squash_sigma(sg_r)),
                               te.squash_sigma(sg).numpy(), rtol=0, atol=1e-6)
