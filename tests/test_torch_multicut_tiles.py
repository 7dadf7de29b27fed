"""Tile presolve of the PyTorch port (ops/multicut_tiles.py) vs the JAX
reference: `tile_presolve` roots, `boundary_edges`, `_tile_local_edges` and
`_tile_weights`, bitwise (tolerance: none) on integer-valued costs at 32x32
and 64x48 with tile 16."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_compression_tpu.ops import multicut_tiles as jt
from image_compression_torch.ops import multicut_tiles as tt

torch.set_num_threads(1)


def _costs(shape, batch=2):
    rng = np.random.default_rng([11, *shape])
    return rng.integers(-8, 9, size=(batch,) + shape + (2,)).astype(
        np.float32)


@pytest.mark.parametrize("rounds", [1, 4])
@pytest.mark.parametrize("shape", [(32, 32), (64, 48)])
def test_tile_presolve_roots_bitwise(shape, rounds):
    costs = _costs(shape)
    got = tt.tile_presolve(torch.as_tensor(costs), 16, rounds)
    assert got.shape == (2,) + shape
    for i in range(2):
        np.testing.assert_array_equal(
            np.asarray(jt.tile_presolve(jnp.asarray(costs[i]), 16, rounds)),
            got[i].numpy())


def test_tile_presolve_real_costs_bitwise_on_separated_values():
    """Costs in multiples of 1/4 are exact in every f32 sum, so real-valued
    weights of that kind give the reference's roots too."""
    rng = np.random.default_rng(12)
    costs = (np.round(rng.normal(size=(2, 32, 32, 2)) * 4) / 4).astype(
        np.float32)
    got = tt.tile_presolve(torch.as_tensor(costs), 16, 4)
    for i in range(2):
        np.testing.assert_array_equal(
            np.asarray(jt.tile_presolve(jnp.asarray(costs[i]), 16, 4)),
            got[i].numpy())


@pytest.mark.parametrize("shape", [(32, 32), (64, 48)])
def test_boundary_edges_bitwise(shape):
    for ref, got in zip(jt.boundary_edges(*shape, 16),
                        tt.boundary_edges(*shape, 16)):
        assert ref.dtype == got.dtype
        np.testing.assert_array_equal(ref, got)


def test_tile_local_edges_and_weights_bitwise():
    for ref, got in zip(jt._tile_local_edges(16), tt._tile_local_edges(16)):
        np.testing.assert_array_equal(ref, got)
    costs = _costs((64, 48))
    got = tt._tile_weights(torch.as_tensor(costs), 16).reshape(2, 12, -1)
    for i in range(2):
        np.testing.assert_array_equal(
            np.asarray(jt._tile_weights(jnp.asarray(costs[i]), 16)),
            got[i].numpy())


def test_tile_presolve_rejects_indivisible_sides():
    with pytest.raises(ValueError, match="divide"):
        tt.tile_presolve(torch.zeros((1, 40, 32, 2)), 16, 1)
