"""Spatial sharding of the PyTorch port (parallel/spatial.py) over meshes
of CPU devices, against the port's unsharded ops and the JAX reference.

- halo_map: a radius-2 blur and the identity over 8 strips equal the
  unsharded op (blur within 1e-6 relative, as the reference's test; the
  identity bitwise).
- multicut_grid_spatial, pixel and matrix aggregation, 8 strips: labels
  bitwise equal to the port's unsharded multicut_grid (icm_sweeps=0) on
  the piecewise-smooth field of the reference's test at 128x128 and on a
  real-valued field that freezes regions; all-attractive costs give one
  region and all-repulsive costs singletons; a mesh of one device runs
  every level in its strip.
- Against the reference, labels bitwise on integer costs at 64x64 over 4
  strips: its multicut_grid_spatial on the conftest's mesh with matrix
  aggregation (chain mode, where the strips run its interpret-mode
  Pallas leaf); with pixel aggregation in chain and random_mate mode, its
  sharded solve composed from the same calls its shard_map body makes
  (hier_gaec on each strip, then the resume), because its shard_map pixel
  solve compiles for 68-96 s per call on the CPU. In random_mate mode each
  strip draws the coins of a strip-sized image, so the sharded labels
  differ from the unsharded ones in both packages.
- sharded_edge_costs equals the reference's at 64x64 over 4 strips
  (bitwise).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from image_compression_tpu.ops import multicut_hier as jh
from image_compression_tpu.parallel import mesh as jmesh
from image_compression_tpu.parallel import spatial as jsp
from image_compression_torch.ops.multicut import multicut_grid
from image_compression_torch.parallel.mesh import make_mesh
from image_compression_torch.parallel.spatial import (halo_map,
                                                      multicut_grid_spatial,
                                                      sharded_edge_costs)

torch.set_num_threads(1)
CPU8 = make_mesh(["cpu"] * 8)
CPU4 = make_mesh(["cpu"] * 4)


def _blur(t):
    p = torch.cat([t[:1].expand(2, -1), t, t[-1:].expand(2, -1)])
    return (p[:-4] + p[1:-3] + p[2:-2] + p[3:-1] + p[4:]) / 5.0


def test_halo_map_matches_unsharded_blur():
    x = torch.as_tensor(np.random.default_rng(0).random((64, 16),
                                                        np.float32))
    got = halo_map(_blur, CPU8, halo=2)(x)
    np.testing.assert_allclose(got.numpy(), _blur(x).numpy(), rtol=1e-6)


def test_halo_map_identity():
    x = torch.as_tensor(np.random.default_rng(1).random((32, 8),
                                                        np.float32))
    assert torch.equal(halo_map(lambda t: t, CPU8, halo=1)(x), x)


def _smooth_costs(size, rng):
    """Piecewise-smooth signed cost field (the reference test's)."""
    base = rng.normal(size=(size // 16 + 1, size // 16 + 1, 3))
    img = np.kron(base, np.ones((16, 16, 1)))[:size, :size]
    img += 0.1 * rng.normal(size=img.shape)
    img = (img - img.min()) / (img.max() - img.min())
    dh = np.abs(np.diff(img, axis=1, append=img[:, -1:])).sum(-1)
    dv = np.abs(np.diff(img, axis=0, append=img[-1:, :])).sum(-1)
    costs = np.stack([1.0 - 8.0 * dh, 1.0 - 8.0 * dv], axis=-1)
    return np.clip(costs, -2, 2).astype(np.float32)


def _freezing_costs(size, rng):
    c = -np.abs(rng.normal(size=(size, size, 2))) - 0.1
    c[: size // 2] *= -1.0
    return c.astype(np.float32)


@pytest.mark.parametrize("agg", ["pixel", "matrix"])
@pytest.mark.parametrize("field", ["smooth", "freezing"])
def test_spatial_equals_unsharded(agg, field):
    rng = np.random.default_rng(0)
    make = _smooth_costs if field == "smooth" else _freezing_costs
    costs = torch.as_tensor(make(128, rng))
    want = multicut_grid(costs[None], icm_sweeps=0, hier_agg=agg)[0]
    got = multicut_grid_spatial(costs, CPU8, agg=agg)
    assert got.dtype == torch.int32 and torch.equal(got, want)
    if field == "freezing":
        assert len(torch.unique(got)) > 128 * 64 // 2


@pytest.mark.parametrize("agg", ["pixel", "matrix"])
def test_spatial_trivial_invariants(agg):
    ones = torch.ones(64, 64, 2)
    assert len(torch.unique(multicut_grid_spatial(ones, CPU8, agg=agg))) == 1
    assert len(torch.unique(multicut_grid_spatial(-ones, CPU8,
                                                  agg=agg))) == 64 * 64


@pytest.mark.parametrize("agg", ["pixel", "matrix"])
def test_spatial_one_strip(agg):
    """A mesh of one device: every level is strip-local and the resume has
    no level left to run."""
    costs = torch.as_tensor(_int_costs(7))
    want = multicut_grid(costs[None], icm_sweeps=0, hier_agg=agg)[0]
    got = multicut_grid_spatial(costs, make_mesh(["cpu"]), agg=agg)
    assert torch.equal(got, want)


def test_spatial_checks():
    with pytest.raises(ValueError, match="shardable"):
        multicut_grid_spatial(torch.ones(64, 64, 2), make_mesh(["cpu"] * 3))
    with pytest.raises(ValueError, match="covering"):
        multicut_grid_spatial(torch.ones(64, 128, 2), CPU8)


def _int_costs(seed):
    return np.random.default_rng(seed).integers(
        -8, 9, (64, 64, 2)).astype(np.float32)


def _reference_sharded_pixel(costs, n, mode):
    """The reference's sharded pixel solve, call for call as its shard_map
    body and continuation run it (parallel/spatial.py)."""
    height, width = costs.shape[:2]
    h_loc = height // n
    sides = jh.plan_levels(height, width, 8)
    caps = jh.default_caps(sides)
    k = len(jh.plan_levels(h_loc, width, 8))
    parts = [jh.hier_gaec(jnp.asarray(costs[i * h_loc:(i + 1) * h_loc]),
                          mode=mode, caps=caps[:k], agg="pixel")
             for i in range(n)]
    gid = [jnp.where(r.frozen, i * h_loc * width + r.final_gid, 0)
           for i, r in enumerate(parts)]
    state = (jnp.concatenate([r.rank_img for r in parts]),
             jnp.concatenate([r.n_regions for r in parts]),
             jnp.concatenate([r.frozen for r in parts]),
             jnp.concatenate(gid), jnp.int32(0))
    res = jh.hier_gaec(jnp.asarray(costs), mode=mode, caps=caps,
                       start_level=k, init_state=state, agg="pixel")
    return np.asarray(jh.smallest_pixel_labels(res))


@pytest.mark.parametrize("mode", ["chain", "random_mate"])
def test_spatial_pixel_matches_reference(mode):
    costs = _int_costs(5)
    got = multicut_grid_spatial(torch.as_tensor(costs), CPU4, mode=mode,
                                agg="pixel")
    want = _reference_sharded_pixel(costs, 4, mode)
    np.testing.assert_array_equal(got.numpy(), want)
    if mode == "random_mate":  # strip coins: not the unsharded solve
        whole = multicut_grid(torch.as_tensor(costs)[None], mode=mode,
                              icm_sweeps=0, hier_agg="pixel")[0]
        assert not torch.equal(got, whole)


@pytest.fixture(scope="module")
def jax_mesh4():
    assert len(jax.devices()) == 8
    return jmesh.make_mesh(jax.devices()[:4])


def test_spatial_matrix_matches_reference(jax_mesh4):
    costs = _int_costs(6)
    got = multicut_grid_spatial(torch.as_tensor(costs), CPU4, agg="matrix")
    xs = jax.device_put(jnp.asarray(costs),
                        NamedSharding(jax_mesh4, P("data")))
    want = np.asarray(jsp.multicut_grid_spatial(xs, jax_mesh4,
                                                agg="matrix"))
    np.testing.assert_array_equal(got.numpy(), want)


def test_sharded_edge_costs_match_reference(jax_mesh4):
    rng = np.random.default_rng(2)
    img = np.full((64, 64, 3), 0.2, np.float32)
    img[10:50, 20:44] = 0.9
    img = np.clip(img + rng.normal(0, 2 / 255, img.shape), 0,
                  1).astype(np.float32)
    got = sharded_edge_costs(torch.as_tensor(img), CPU4, halo=8)
    xs = jax.device_put(jnp.asarray(img),
                        NamedSharding(jax_mesh4, P("data")))
    want = np.asarray(jsp.sharded_edge_costs(xs, jax_mesh4, halo=8))
    assert got.shape == (64, 64, 2)
    np.testing.assert_array_equal(got.numpy(), want)
