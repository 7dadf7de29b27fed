"""Grid multicut entry of the PyTorch port vs the JAX reference: the
hierarchical branch, the pad-to-32 branch, the sorted finishing rounds of
images the top supertile does not cover, relabel_connected, the level
plans and cap schedules, and globalize."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_compression_tpu.ops import multicut as jmc
from image_compression_tpu.ops import multicut_hier as jh
from image_compression_torch.ops import multicut_hier as th
from image_compression_torch.ops.multicut import (multicut_grid,
                                                  multicut_objective,
                                                  relabel_connected)

torch.set_num_threads(1)

KW = dict(hier_rounds=(2, 1), hier_caps="flat64")


@functools.partial(jax.jit, static_argnames=("caps",))
def _j_labels(costs, caps):
    return jmc.multicut_grid(costs, icm_sweeps=0, hier_agg="matrix",
                             max_rounds=3, hier_rounds=(2, 1),
                             hier_caps=caps)


@pytest.mark.parametrize("side,caps", [(16, "flat64"), (32, "flat64"),
                                       (32, "half"), (32, None),
                                       (40, "flat64"), (50, None)])
def test_labels_bitwise(side, caps):
    """Integer costs: labels equal the reference's for square sides on the
    hierarchical branch (16, 32) and the pad-to-32 branch (40, 50), batched
    over two images."""
    rng = np.random.default_rng(side)
    costs = rng.integers(-8, 9, size=(2, side, side, 2)).astype(np.float32)
    got = multicut_grid(torch.as_tensor(costs), hier_rounds=(2, 1),
                        hier_caps=caps)
    for i in range(2):
        np.testing.assert_array_equal(
            np.asarray(_j_labels(jnp.asarray(costs[i]), caps)),
            got[i].numpy())


@pytest.mark.parametrize("shape", [(48, 48), (32, 64), (64, 32), (40, 72)])
def test_sorted_finish_bitwise(shape):
    """Integer costs on images whose top supertile does not cover them
    (48x48: top 16; 32x64 and 64x32: top 32; 40x72 pads to 64x96, top 32):
    the sorted finishing rounds give the reference's labels, batched over
    two images."""
    rng = np.random.default_rng(sum(shape))
    costs = rng.integers(-8, 9, size=(2,) + shape + (2,)).astype(np.float32)
    got = multicut_grid(torch.as_tensor(costs), **KW)
    for i in range(2):
        np.testing.assert_array_equal(
            np.asarray(_j_labels(jnp.asarray(costs[i]), "flat64")),
            got[i].numpy())


def test_sorted_finish_to_one_region():
    """Attractive costs: the first round leaves each image one region, so
    the next round has no pair left and the rounds stop there."""
    costs = np.random.default_rng(3).integers(
        1, 9, size=(2, 32, 64, 2)).astype(np.float32)
    got = multicut_grid(torch.as_tensor(costs), **KW)
    for i in range(2):
        np.testing.assert_array_equal(
            np.asarray(_j_labels(jnp.asarray(costs[i]), "flat64")),
            got[i].numpy())
    assert not bool(got.any())


def test_sorted_finish_real_costs_objective():
    """Real-valued costs: f32 pair sums may be grouped differently, so the
    port is held to the reference's objective within 1%."""
    costs = np.random.default_rng(1).normal(
        size=(2, 48, 80, 2)).astype(np.float32)
    got = multicut_grid(torch.as_tensor(costs), **KW).numpy()
    for i in range(2):
        ref = np.asarray(_j_labels(jnp.asarray(costs[i]), "flat64"))
        want = multicut_objective(costs[i], ref)
        assert abs(multicut_objective(costs[i], got[i]) - want) <= \
            0.01 * abs(want)


def test_photo_shape_solves():
    """A 375x500 photo (ImageNet's commonest shape) pads to 384x512 and
    finishes with sorted rounds: minlabel labels of the input's shape."""
    costs = torch.as_tensor(np.random.default_rng(2).integers(
        -8, 9, size=(1, 375, 500, 2)).astype(np.float32))
    labels = multicut_grid(costs, **KW)[0]
    assert labels.shape == (375, 500)
    flat = torch.arange(375 * 500, dtype=torch.int32).reshape(375, 500)
    assert bool((labels <= flat).all())
    assert torch.equal(labels[labels == flat].sort().values,
                       torch.unique(labels))


@pytest.mark.parametrize("n_labels", [2, 5])
def test_relabel_connected_bitwise(n_labels):
    rng = np.random.default_rng(n_labels)
    labels = rng.integers(0, n_labels, size=(3, 20, 24)).astype(np.int32)
    got = relabel_connected(torch.as_tensor(labels))
    for i in range(3):
        np.testing.assert_array_equal(
            np.asarray(jmc.relabel_connected(jnp.asarray(labels[i]))),
            got[i].numpy())


def test_relabel_connected_splits_disconnected_cluster():
    labels = torch.zeros((1, 3, 5), dtype=torch.int32)
    labels[0, :, 2] = 7  # a wall splits label 0 in two
    got = relabel_connected(labels)[0]
    assert got[0, 0] == 0 and got[0, 3] == 3 and got[0, 2] == 2
    assert len(torch.unique(got)) == 3


@pytest.mark.parametrize("shape", [(64, 64), (32, 64), (48, 80), (8, 8),
                                   (12, 16), (256, 256)])
def test_level_plans_and_caps(shape):
    sides = th.plan_levels(*shape, 8)
    assert sides == jh.plan_levels(*shape, 8)
    if sides:
        assert th.default_caps(sides) == jh.default_caps(sides)
        for kind in ("half", "flat64"):
            assert th.lean_caps(sides, kind) == jh.lean_caps(sides, kind)


def test_globalize_bitwise():
    rng = np.random.default_rng(4)
    costs = rng.integers(-3, 4, size=(32, 64, 2)).astype(np.float32)
    caps = jh.default_caps(jh.plan_levels(32, 64, 8))
    ref = jh.hier_gaec(jnp.asarray(costs), caps=caps, agg="matrix",
                       rounds_per_level=[2, 1], leaf="fused")
    res = th.hier_gaec(torch.as_tensor(costs[None]), caps=caps,
                       rounds_per_level=[2, 1])
    np.testing.assert_array_equal(np.asarray(jh.globalize(ref, 32, 64)),
                                  th.globalize(res, 32, 64)[0].numpy())
