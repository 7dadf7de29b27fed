"""hier_gaec's resume (start_level / init_state) in the PyTorch port.

The state after the strip-local levels is built as the spatially sharded
solve builds it: height strips of the image run the levels that fit them
(as one batch), their frozen ids and min-pixel ids move to global ids, and
the strips are stacked in row order. Resumed from there:
- the port equals its own unsharded run bit for bit (tolerance: none) in
  every HierResult field and in the labels, with pixel and matrix
  aggregation, the 5-tuple (pixel rebuild) and the 7-tuple (slot-space
  handoff), on integer costs and on real-valued costs that freeze
  regions, at 64x64 and 128x128;
- the port equals the JAX reference's resume from the same state, labels
  bitwise, on integer costs at 64x64 with matrix aggregation (the pixel
  resume is held to the reference through the sharded solve,
  tests/test_torch_spatial.py);
- the argument checks are the reference's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_compression_tpu.ops import multicut_hier as jh
from image_compression_torch.ops import multicut_hier as th

torch.set_num_threads(1)


def _costs(kind, size, seed=0):
    rng = np.random.default_rng([seed, size])
    if kind == "int":
        c = rng.integers(-8, 9, size=(size, size, 2))
    else:  # repulsive real costs: 16x16 tiles overflow their 128 slots
        c = -np.abs(rng.normal(size=(size, size, 2))) - 0.1
        c[: size // 2] *= -1.0  # the top half merges, the bottom freezes
    return torch.as_tensor(c.astype(np.float32))[None]


def _strip_state(costs, h_loc, agg, seven):
    """(start_level, init_state) after the levels of h_loc-row strips."""
    _, height, width, _ = costs.shape
    n = height // h_loc
    sides = th.plan_levels(height, width)
    caps = th.default_caps(sides)
    k = len(th.plan_levels(h_loc, width))
    res = th.hier_gaec(costs.reshape(n, h_loc, width, 2), caps=caps[:k],
                       agg=agg)
    off = (torch.arange(n, dtype=torch.int32) * (h_loc * width))
    gid = torch.where(res.frozen, res.final_gid + off[:, None, None], 0)
    state = (res.rank_img.reshape(1, height, width),
             res.n_regions.reshape(1, -1),
             res.frozen.reshape(1, height, width),
             gid.reshape(1, height, width), res.overflow.sum()[None])
    if seven:
        m = torch.where(res.minpix < h_loc * width,
                        res.minpix + off[:, None, None], height * width)
        state += (res.pair.reshape(1, -1, *res.pair.shape[2:]),
                  m.reshape(1, -1, m.shape[-1]))
    return k, state


CASES = [(64, 16), (64, 8), (128, 32)]


# the matrix 5-tuple rebuilds the pair sums from pixels, which regroups
# f32 sums: bitwise on integer-valued costs only, as in the reference
@pytest.mark.parametrize("size,h_loc", CASES)
@pytest.mark.parametrize("agg,seven,kind", [
    ("pixel", False, "int"), ("matrix", False, "int"),
    ("matrix", True, "int"), ("pixel", False, "freeze"),
    ("matrix", True, "freeze")])
def test_resume_equals_unsharded(size, h_loc, agg, seven, kind):
    costs = _costs(kind, size)
    whole = th.hier_gaec(costs, agg=agg)
    k, state = _strip_state(costs, h_loc, agg, seven)
    got = th.hier_gaec(costs, agg=agg, start_level=k, init_state=state)
    for f in ("rank_img", "n_regions", "frozen", "final_gid", "minpix",
              "pair"):
        a, b = getattr(got, f), getattr(whole, f)
        assert (a is None) == (b is None), f
        if a is not None:
            assert torch.equal(a, b), f
    assert torch.equal(th.smallest_pixel_labels(got),
                       th.smallest_pixel_labels(whole))
    if kind == "freeze":
        assert bool(whole.frozen.any())


@pytest.mark.parametrize("agg,seven", [("matrix", False), ("matrix", True)])
def test_resume_matches_reference(agg, seven):
    costs = _costs("int", 64, seed=3)
    k, state = _strip_state(costs, 16, agg, seven)
    got = th.smallest_pixel_labels(th.hier_gaec(
        costs, agg=agg, start_level=k, init_state=state))[0]
    j_state = [jnp.asarray(state[0][0].numpy().astype(np.int32)),
               jnp.asarray(state[1][0].numpy().astype(np.int32)),
               jnp.asarray(state[2][0].numpy()),
               jnp.asarray(state[3][0].numpy()),
               jnp.int32(int(state[4][0]))]
    if seven:
        j_state += [jnp.asarray(state[5][0].numpy()),
                    jnp.asarray(state[6][0].numpy().astype(np.float32))]
    want = jh.smallest_pixel_labels(jh.hier_gaec(
        jnp.asarray(costs[0].numpy()), agg=agg, start_level=k,
        init_state=tuple(j_state)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_resume_argument_checks():
    costs = _costs("int", 64)
    k, state = _strip_state(costs, 16, "matrix", True)
    with pytest.raises(ValueError, match="go together"):
        th.hier_gaec(costs, start_level=k)
    with pytest.raises(ValueError, match="go together"):
        th.hier_gaec(costs, init_state=state)
    with pytest.raises(ValueError, match="7-tuple"):
        th.hier_gaec(costs, agg="pixel", start_level=k, init_state=state)
    with pytest.raises(ValueError, match="fresh start"):
        th.hier_gaec(costs, leaf="fused", start_level=k, init_state=state)
    with pytest.raises(ValueError, match="outside"):
        th.hier_gaec(costs, start_level=9, init_state=state)
