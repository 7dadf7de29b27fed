"""Pixel aggregation (hier_agg="pixel") and the public solver helpers of
the PyTorch port vs the JAX reference.

- Labels of the pixel-aggregation hierarchy bitwise (tolerance: none) on
  integer-valued costs, chain and random_mate, at 32x32, 40x40 (padded to
  64x64) and 48x80 (sorted finish), batch 2; every HierResult field of the
  pixel branch too.
- In the port, pixel labels equal matrix labels on integer costs.
- `multicut_upper_bound` within 1e-5 relative (f32 sums grouped
  differently); `brute_force_multicut` equal on 3x3; `produces_minlabel`
  equal over a grid of settings.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_compression_tpu.ops import multicut as jmc
from image_compression_tpu.ops import multicut_hier as jh
from image_compression_torch.ops import multicut as tmc
from image_compression_torch.ops import multicut_hier as th

torch.set_num_threads(1)


def _int_costs(shape, seed, batch=2):
    rng = np.random.default_rng([seed, *shape])
    return rng.integers(-8, 9, size=(batch,) + shape + (2,)).astype(
        np.float32)


@pytest.mark.parametrize("mode", ["chain", "random_mate"])
@pytest.mark.parametrize("shape", [(32, 32), (40, 40), (48, 80)])
def test_pixel_labels_bitwise(shape, mode):
    costs = _int_costs(shape, 1)
    kw = dict(mode=mode, icm_sweeps=0, hier_agg="pixel")
    got = tmc.multicut_grid(torch.as_tensor(costs), **kw)
    for i in range(2):
        np.testing.assert_array_equal(
            np.asarray(jmc.multicut_grid(jnp.asarray(costs[i]), **kw)),
            got[i].numpy())


@functools.partial(jax.jit, static_argnames=("mode", "caps"))
def _j_pixel_state(costs, mode, caps):
    res = jh.hier_gaec(costs, mode=mode, caps=list(caps), agg="pixel",
                       rounds_per_level=[2, 1])
    fields = ("rank_img", "n_regions", "frozen", "final_gid", "overflow")
    return {f: getattr(res, f) for f in fields}, jh.smallest_pixel_labels(res)


@pytest.mark.parametrize("mode,caps", [("chain", "flat64"),
                                       ("random_mate", "default"),
                                       ("chain", "tight")])
def test_pixel_hier_state_bitwise(mode, caps):
    """Every field of the pixel branch's HierResult on 32x64; the tight
    caps (64, 32, 32) freeze regions, so the freeze-time minimum runs."""
    costs = _int_costs((32, 64), 2, batch=1)
    sides = th.plan_levels(32, 64)
    caps = {"flat64": th.lean_caps(sides, "flat64"),
            "default": th.default_caps(sides), "tight": [64, 32, 32]}[caps]
    ref, ref_labels = _j_pixel_state(jnp.asarray(costs[0]), mode,
                                     tuple(caps))
    res = th.hier_gaec(torch.as_tensor(costs), mode=mode, caps=caps,
                       agg="pixel", rounds_per_level=[2, 1])
    assert res.minpix is None and res.pair is None
    for field, want in ref.items():
        np.testing.assert_array_equal(np.asarray(want),
                                      getattr(res, field)[0].numpy(),
                                      err_msg=field)
    np.testing.assert_array_equal(np.asarray(ref_labels),
                                  th.smallest_pixel_labels(res)[0].numpy())
    if caps == [64, 32, 32]:
        assert int(res.overflow[0]) > 0


@pytest.mark.parametrize("shape", [(32, 32), (64, 64), (48, 80)])
def test_pixel_equals_matrix_in_the_port(shape):
    costs = torch.as_tensor(_int_costs(shape, 3))
    kw = dict(icm_sweeps=0, hier_rounds=(2, 1), hier_caps="flat64")
    assert torch.equal(tmc.multicut_grid(costs, hier_agg="pixel", **kw),
                       tmc.multicut_grid(costs, hier_agg="matrix", **kw))


@pytest.mark.parametrize("shape", [(16, 16), (33, 47)])
def test_upper_bound(shape):
    """Real-valued costs: within 1e-5 relative; at least the objective."""
    costs = np.random.default_rng(4).normal(
        size=(2,) + shape + (2,)).astype(np.float32)
    got = tmc.multicut_upper_bound(torch.as_tensor(costs))
    labels = tmc.multicut_grid(torch.as_tensor(costs)).numpy()
    for i in range(2):
        want = float(jmc.multicut_upper_bound(jnp.asarray(costs[i])))
        assert abs(float(got[i]) - want) <= 1e-5 * abs(want)
        assert float(got[i]) >= tmc.multicut_objective(costs[i],
                                                       labels[i]) - 1e-4


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_brute_force_equal(seed):
    costs = np.random.default_rng(seed).normal(size=(3, 3, 2))
    ref_labels, ref_obj = jmc.brute_force_multicut(costs)
    labels, obj = tmc.brute_force_multicut(costs)
    np.testing.assert_array_equal(ref_labels, labels)
    assert obj == ref_obj
    with pytest.raises(ValueError):
        tmc.brute_force_multicut(np.zeros((4, 4, 2)))


def test_produces_minlabel_equal():
    for shape in [(8, 8), (12, 64), (16, 16), (40, 72), (256, 256)]:
        for mode in ("chain", "mutual", "random_mate", "hybrid"):
            for icm in (0, 8):
                for hier in (True, False):
                    assert tmc.produces_minlabel(*shape, mode, icm, hier) == \
                        jmc.produces_minlabel(*shape, mode, icm, hier)


def test_batched_entry_uses_reference_defaults():
    """multicut_grid_batched: 8 ICM sweeps and pixel aggregation, as the
    reference's batched entry."""
    costs = _int_costs((32, 32), 5)
    got = tmc.multicut_grid_batched(torch.as_tensor(costs))
    np.testing.assert_array_equal(
        np.asarray(jmc.multicut_grid_batched(jnp.asarray(costs))),
        got.numpy())
