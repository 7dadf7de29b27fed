"""Solver modes of the PyTorch port vs the JAX reference: chain,
random_mate, mutual and hybrid through the sorted path (hier=False, with
the tile presolve and boundary rounds where the sides divide by 16),
random_mate through the hierarchy, and the tiny-grid ensemble. ICM sweeps,
`return_rounds` and real-valued costs are in test_torch_multicut_rounds.py.

Integer-valued costs: labels bitwise (tolerance: none), batch 2 unless
stated."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_compression_tpu.ops import multicut as jmc
from image_compression_torch.ops.multicut import multicut_grid

torch.set_num_threads(1)


def _int_costs(shape, seed, batch=2, low=-8, high=9):
    rng = np.random.default_rng([seed, *shape])
    return rng.integers(low, high, size=(batch,) + shape + (2,)).astype(
        np.float32)


def _assert_labels_equal(costs, **kw):
    got = multicut_grid(torch.as_tensor(costs), **kw)
    for i in range(costs.shape[0]):
        np.testing.assert_array_equal(
            np.asarray(jmc.multicut_grid(jnp.asarray(costs[i]), **kw)),
            got[i].numpy(), err_msg=f"image {i}")


@pytest.mark.parametrize("shape", [(16, 16), (32, 48)])
@pytest.mark.parametrize("mode", ["chain", "random_mate", "mutual",
                                  "hybrid"])
def test_sorted_path_bitwise(mode, shape):
    """hier=False: 16x16 runs the full sorted rounds only; 32x48 runs the
    tile presolve, the boundary rounds and the full rounds."""
    _assert_labels_equal(_int_costs(shape, 1), mode=mode, hier=False,
                         icm_sweeps=0)


@pytest.mark.parametrize("mode", ["random_mate", "mutual", "hybrid"])
def test_sorted_rounds_stop_per_image(mode):
    """Three images that converge after different numbers of rounds (one
    all-attractive): each stops when a round leaves it unchanged, as the
    reference's vmapped loop stops it; labels and rounds run per image
    equal the reference's."""
    costs = _int_costs((32, 48), 2, batch=3)
    costs[1] = np.abs(costs[1]) + 1
    costs[2] = _int_costs((32, 48), 3, batch=1, low=-2)[0]
    labels, rounds = multicut_grid(torch.as_tensor(costs), mode=mode,
                                   hier=False, max_rounds=20, icm_sweeps=0,
                                   return_rounds=True)
    assert len(set(rounds.tolist())) > 1
    for i in range(3):
        ref, ref_rounds = jmc.multicut_grid(
            jnp.asarray(costs[i]), mode=mode, hier=False, max_rounds=20,
            icm_sweeps=0, return_rounds=True)
        np.testing.assert_array_equal(np.asarray(ref), labels[i].numpy())
        assert int(ref_rounds) == int(rounds[i])


@pytest.mark.parametrize("shape", [(32, 32), (48, 80)])
def test_hierarchy_random_mate_bitwise(shape):
    """random_mate through the matrix hierarchy (the unfused loop: the leaf
    is chain-only) with its default round schedule and caps; 48x80 also
    runs the random-mate finishing rounds."""
    _assert_labels_equal(_int_costs(shape, 4), mode="random_mate",
                         icm_sweeps=0, hier_agg="matrix")


@pytest.mark.parametrize("shape", [(8, 8), (8, 40), (15, 15), (12, 64)])
def test_tiny_grid_ensemble_bitwise(shape):
    """Sides under 16: chain and random_mate sorted solves, the better one
    kept per image."""
    _assert_labels_equal(_int_costs(shape, 5), icm_sweeps=0)


def test_tiny_grid_ensemble_picks_per_image():
    """Across 8 images of 8x8 each solve wins somewhere, and the port picks
    the same one per image as the reference."""
    costs = _int_costs((8, 8), 6, batch=8)
    c = torch.as_tensor(costs)
    lab_c = multicut_grid(c, mode="chain", hier=False)
    lab_r = multicut_grid(c, mode="random_mate", hier=False)
    got = multicut_grid(c)
    from_c = (got == lab_c).all(dim=(1, 2))
    from_r = (got == lab_r).all(dim=(1, 2))
    assert bool(from_c.any()) and bool((from_r & ~from_c).any())
    _assert_labels_equal(costs, icm_sweeps=0)


def test_tiny_grid_labels_are_roots_as_in_the_reference():
    """With icm_sweeps=0 the tiny-grid labels are sorted-round roots, not
    smallest pixel ids (produces_minlabel is False), and chain's two capped
    doublings can leave a label that is none of its own region's pixels.
    The reference's compress still reads them with minlabel=True; the port
    reproduces its labels exactly there, such images included."""
    rng = np.random.default_rng(1)
    costs = rng.integers(-3, 9, size=(8, 12, 64, 2)).astype(np.float32)
    got = multicut_grid(torch.as_tensor(costs)).reshape(8, -1).long()
    own = torch.gather(got, 1, got) == got  # pixel L carries label L
    flat = torch.arange(12 * 64)
    smallest = torch.full_like(got, 12 * 64).scatter_reduce(
        1, got, flat.expand(8, -1), "amin").gather(1, got)
    assert bool((smallest != got).any())
    assert bool((~own).any())
    _assert_labels_equal(costs, icm_sweeps=0)
