"""Multicut leaf of the PyTorch port vs the JAX reference.

The port's leaf (ops/multicut_leaf.py) has a CUDA kernel and a plain
PyTorch version; on the CPU the wrapper runs the plain version. Both the
fused leaf and the level-by-level ("unfused") path must reproduce the
reference's matrix-aggregation state bit for bit on integer-valued costs,
for the reference's XLA loop and its Pallas leaf (interpret mode on the
CPU) alike. The kernel-vs-plain comparison needs a GPU and lives in
tests/test_torch_cuda.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_compression_tpu.ops import multicut_leaf as jleaf
from image_compression_tpu.ops.multicut import multicut_grid as j_grid
from image_compression_tpu.ops.multicut_hier import hier_gaec as j_hier
from image_compression_tpu.ops.multicut_hier import (
    smallest_pixel_labels as j_labels)
from image_compression_torch.ops import multicut_leaf as tleaf
from image_compression_torch.ops.multicut import (multicut_grid,
                                                  multicut_objective)
from image_compression_torch.ops.multicut_hier import (
    default_caps, hier_gaec, lean_caps, plan_levels, smallest_pixel_labels)

torch.set_num_threads(1)

STATE_FIELDS = ("rank_img", "n_regions", "frozen", "final_gid", "overflow",
                "minpix", "pair")


def _caps(kind, shape):
    sides = plan_levels(*shape, 8)
    return lean_caps(sides, "flat64") if kind == "flat64" else \
        default_caps(sides)


def _int_costs(shape, seed=3):
    rng = np.random.default_rng(seed)
    return rng.integers(-8, 9, size=shape + (2,)).astype(np.float32)


def _heavy_costs(seed=5):
    rng = np.random.default_rng(seed)
    return (-np.abs(rng.normal(size=(64, 64, 2))) - 0.1).astype(np.float32)


@functools.partial(jax.jit, static_argnames=("caps", "leaf"))
def _j_state(costs, caps, leaf):
    """Reference state fields and labels (jitted: one XLA program instead of
    an op-by-op run)."""
    res = j_hier(costs, caps=list(caps), agg="matrix",
                 rounds_per_level=[2, 1], leaf=leaf)
    return {f: getattr(res, f) for f in STATE_FIELDS}, j_labels(res)


def _reference(costs, caps, leaf):
    fields, labels = _j_state(jnp.asarray(costs), tuple(caps), leaf)
    return {k: np.asarray(v) for k, v in fields.items()}, np.asarray(labels)


@functools.lru_cache(maxsize=None)
def _case(kind, shape, j_leaf):
    """(costs, caps, reference) of one case, computed once per process."""
    if kind == "heavy":
        costs, caps = _heavy_costs(), _caps("flat64", shape)
    else:
        costs, caps = _int_costs(shape), _caps(kind, shape)
    return costs, caps, _reference(costs, caps, j_leaf)


def _assert_state_equal(ref, res, index=0):
    fields, labels = ref
    for field in STATE_FIELDS:
        np.testing.assert_array_equal(fields[field],
                                      getattr(res, field)[index].numpy(),
                                      err_msg=field)
    np.testing.assert_array_equal(labels,
                                  smallest_pixel_labels(res)[index].numpy())


CASES = [("flat64", (64, 64)), ("default", (64, 64)), ("flat64", (32, 64)),
         ("default", (32, 64)), ("heavy", (64, 64))]


@pytest.mark.parametrize("j_leaf", ["xla", "fused"])
@pytest.mark.parametrize("leaf", ["fused", "unfused"])
@pytest.mark.parametrize("kind,shape", CASES)
def test_hier_state_bitwise(kind, shape, leaf, j_leaf):
    """Every HierResult field equals the reference's (agg="matrix") on
    integer costs and on the heavy-freezing recipe, for both leaf paths of
    each side."""
    costs, caps, ref = _case(kind, shape, j_leaf)
    res = hier_gaec(torch.as_tensor(costs[None]), caps=caps,
                    rounds_per_level=[2, 1], leaf=leaf)
    if kind == "heavy":
        assert int(res.overflow[0]) > 1000  # the freeze path really ran
    _assert_state_equal(ref, res)


def test_batch_is_independent_per_image():
    """A batch of three images gives each image the state it gets alone."""
    costs = np.stack([_int_costs((32, 32), s) for s in (1, 2, 3)])
    caps = _caps("flat64", (32, 32))
    res = hier_gaec(torch.as_tensor(costs), caps=caps,
                    rounds_per_level=[2, 1])
    for i in range(3):
        _assert_state_equal(_reference(costs[i], caps, "xla"), res, index=i)


@pytest.mark.parametrize("s1", [64, 128])
def test_leaf_levels_fused_matches_pallas_leaf(s1):
    """The leaf module itself: the port's leaf_levels_fused (plain version
    on the CPU) returns the reference Pallas kernel's handed-over state."""
    costs = _int_costs((32, 64), seed=11)
    ref = jleaf.leaf_levels_fused(jnp.asarray(costs), s1, 2, 1,
                                  interpret=True)
    got = tleaf.leaf_levels_fused(torch.as_tensor(costs[None]), s1, 2, 1)
    names = ("rank_img", "ncand", "frozen", "final_gid", "overflow", "sym",
             "m")
    for name, r, g in zip(names, ref, got):
        g = g[0] if name in ("rank_img", "frozen", "final_gid",
                             "overflow") else g
        np.testing.assert_array_equal(np.asarray(r), g.numpy(), err_msg=name)


def test_through_multicut_grid():
    """Production profile through the public entry: labels bit-equal to the
    reference on integer costs; on real costs the fused and unfused paths
    agree in objective within f32-regrouping noise."""
    rng = np.random.default_rng(7)
    kw = dict(hier_rounds=(2, 1), hier_caps="flat64")
    ci = rng.integers(-8, 9, size=(64, 64, 2)).astype(np.float32)
    ref = np.asarray(j_grid(jnp.asarray(ci), icm_sweeps=0, hier_agg="matrix",
                            **kw))
    for leaf in ("fused", "unfused"):
        got = multicut_grid(torch.as_tensor(ci[None]), hier_leaf=leaf, **kw)
        np.testing.assert_array_equal(ref, got[0].numpy())

    cr = rng.normal(size=(64, 64, 2)).astype(np.float32)
    ref = np.asarray(j_grid(jnp.asarray(cr), icm_sweeps=0, hier_agg="matrix",
                            **kw))
    o_ref = multicut_objective(cr, ref)
    for leaf in ("fused", "unfused"):
        got = multicut_grid(torch.as_tensor(cr[None]), hier_leaf=leaf, **kw)
        o = multicut_objective(cr, got[0].numpy())
        assert abs(o - o_ref) <= 0.01 * abs(o_ref) + 1e-3


def test_trivial_invariants():
    """All-attractive -> one cluster; all-repulsive -> all singletons."""
    ones = torch.ones((1, 32, 32, 2))
    kw = dict(hier_rounds=(2, 1), hier_caps="flat64", hier_leaf="fused")
    assert len(torch.unique(multicut_grid(ones, **kw))) == 1
    assert len(torch.unique(multicut_grid(-ones, **kw))) == 32 * 32


def test_fused_requires_applicable_config():
    """leaf='fused' fails loudly off the supported envelope."""
    with pytest.raises(ValueError, match="fused"):
        hier_gaec(torch.ones((1, 32, 32, 2)), caps=[64, 256, 256],
                  leaf="fused")


def test_cpu_tensor_runs_plain_version_without_counting():
    """On a CPU tensor the wrapper runs the plain version; the launch
    counter counts kernel launches only."""
    before = tleaf.launches
    args = (*tleaf.leaf_inputs(torch.as_tensor(_int_costs((32, 32))[None])),
            64, 2, 1, 32 * 32)
    got = tleaf.leaf_core(*args)
    want = tleaf.leaf_plain(*args)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert tleaf.launches == before


def test_leaf_cuda_rejects_cpu_tensors():
    args = tleaf.leaf_inputs(torch.as_tensor(_int_costs((32, 32))[None]))
    with pytest.raises(ValueError, match="CUDA"):
        tleaf.leaf_cuda(*args, 64, 2, 1, 32 * 32)
