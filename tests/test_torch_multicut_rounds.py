"""ICM sweeps, `return_rounds` and real-valued costs of the PyTorch port's
solver vs the JAX reference, across its branches (hierarchy with matrix or
pixel aggregation, pad-to-32, sorted path, sorted finish).

Integer-valued costs: labels and rounds bitwise (tolerance: none), batch 2.
Real-valued costs: f32 sums are grouped differently, so the objective is
held within 1% of the reference's."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_compression_tpu.ops import multicut as jmc
from image_compression_torch.ops.multicut import (multicut_grid,
                                                  multicut_objective)

torch.set_num_threads(1)


def _int_costs(shape, seed, batch=2):
    rng = np.random.default_rng([seed, *shape])
    return rng.integers(-8, 9, size=(batch,) + shape + (2,)).astype(
        np.float32)


def _assert_labels_equal(costs, **kw):
    got = multicut_grid(torch.as_tensor(costs), **kw)
    for i in range(costs.shape[0]):
        np.testing.assert_array_equal(
            np.asarray(jmc.multicut_grid(jnp.asarray(costs[i]), **kw)),
            got[i].numpy(), err_msg=f"image {i}")


@pytest.mark.parametrize("kw", [dict(hier_agg="matrix"),
                                dict(hier_agg="pixel", mode="random_mate"),
                                dict(hier=False, mode="hybrid")])
def test_icm_sweeps_bitwise(kw):
    """8 ICM sweeps and the connectivity relabel after the hierarchy and
    after the sorted path, at 32x32."""
    _assert_labels_equal(_int_costs((32, 32), 7), icm_sweeps=8, **kw)


@pytest.mark.parametrize("shape,kw", [
    ((16, 16), dict(mode="random_mate", hier=False)),
    ((32, 48), dict(mode="hybrid", hier=False)),
    ((48, 80), dict(mode="chain", hier_agg="matrix", hier_rounds=(2, 1),
                    hier_caps="flat64")),
    ((32, 32), dict(mode="chain", hier_agg="matrix")),
    ((40, 40), dict(mode="random_mate", hier_agg="pixel"))])
def test_return_rounds(shape, kw):
    """The sorted rounds run per image (0 where the hierarchy covers the
    image) equal the reference's, and so do the labels."""
    costs = _int_costs(shape, 8)
    labels, rounds = multicut_grid(torch.as_tensor(costs), icm_sweeps=0,
                                   return_rounds=True, **kw)
    assert rounds.shape == (2,)
    for i in range(2):
        ref, ref_rounds = jmc.multicut_grid(jnp.asarray(costs[i]),
                                            icm_sweeps=0, return_rounds=True,
                                            **kw)
        np.testing.assert_array_equal(np.asarray(ref), labels[i].numpy())
        assert int(ref_rounds) == int(rounds[i])


@pytest.mark.parametrize("kw", [dict(mode="random_mate"),
                                dict(mode="mutual"), dict(mode="hybrid"),
                                dict(mode="chain", hier_agg="pixel",
                                     icm_sweeps=8)])
def test_real_costs_objective(kw):
    """Real-valued costs at 48x80: objective within 1% of the
    reference's."""
    costs = np.random.default_rng(9).normal(
        size=(2, 48, 80, 2)).astype(np.float32)
    kw = dict(dict(icm_sweeps=0), **kw)
    got = multicut_grid(torch.as_tensor(costs), **kw).numpy()
    for i in range(2):
        ref = np.asarray(jmc.multicut_grid(jnp.asarray(costs[i]), **kw))
        want = multicut_objective(costs[i], ref)
        assert abs(multicut_objective(costs[i], got[i]) - want) <= \
            0.01 * abs(want)
