"""Exact pixel ids past 2^24 in the PyTorch port's solver.

The reference carries min-pixel ids in f32, exact only below 2^24 pixels;
the port carries them as int32. Fed odd pixel ids offset past 2^24 (which
f32 cannot hold), `leaf_plain`, the slot minimum of the pixel aggregation
and `smallest_pixel_labels` return them exactly (tolerance: none): the same
regions as with the plain ids, each id mapped by the same increasing map.
The CUDA source's counterpart is in tests/test_torch_leaf_source.py; the
card solves a 3648x5472 field in chip_smoke.py."""

import numpy as np
import pytest
import torch

from image_compression_torch.ops import multicut_hier as th
from image_compression_torch.ops import multicut_leaf as leaf

torch.set_num_threads(1)

OFF = 2 ** 24 + 1


def _big(ids: torch.Tensor) -> torch.Tensor:
    """An increasing map onto odd ids past 2^24."""
    return ids * 2 + OFF


def test_odd_ids_past_2_24_are_not_f32():
    ids = _big(torch.arange(4, dtype=torch.int64))
    assert not torch.equal(ids.to(torch.float32).to(torch.int64), ids)


@pytest.mark.parametrize("kind", ["int", "heavy"])
def test_leaf_plain_exact_ids(kind):
    rng = np.random.default_rng(0)
    if kind == "heavy":  # nothing merges: most regions freeze under gid
        costs = -rng.integers(1, 9, size=(2, 32, 32, 2))
    else:
        costs = rng.integers(-8, 9, size=(2, 32, 32, 2))
    w0h, w0v, wmid, pix = leaf.leaf_inputs(torch.as_tensor(
        costs.astype(np.float32)))
    n_pix = 32 * 32
    want = leaf.leaf_plain(w0h, w0v, wmid, pix, 64, 2, 1, n_pix)
    big_n = int(_big(torch.tensor(4 * n_pix)))
    got = leaf.leaf_plain(w0h, w0v, wmid, _big(pix).to(torch.int32), 64, 2,
                          1, big_n)
    rank, gid, sym, m, ncand, over = want
    for name, a, b in (("rank", rank, got[0]), ("sym", sym, got[2]),
                       ("ncand", ncand, got[4]), ("over", over, got[5])):
        assert torch.equal(a, b), name
    assert got[3].dtype == torch.int32
    assert torch.equal(got[3], torch.where(m < n_pix, _big(m), big_n).to(
        torch.int32))
    frozen = rank < 0
    assert torch.equal(got[1], torch.where(frozen, _big(gid), 0).to(
        torch.int32))
    if kind == "heavy":
        assert int(over.sum()) > 0 and bool((got[1] > 2 ** 24).any())


def test_slot_min_exact_ids():
    rng = np.random.default_rng(1)
    ranks = torch.as_tensor(rng.integers(-1, 8, size=(5, 64)))
    pix = torch.arange(5 * 64, dtype=torch.int32).reshape(5, 64)
    want = th._slot_min(ranks, pix, 8, 5 * 64)
    big_n = int(_big(torch.tensor(5 * 64)))
    got = th._slot_min(ranks, _big(pix).to(torch.int32), 8, big_n)
    assert torch.equal(got, torch.where(want < 5 * 64, _big(want),
                                        big_n).to(torch.int32))


@pytest.mark.parametrize("agg", ["matrix", "pixel"])
def test_smallest_pixel_labels_exact_ids(agg):
    """Matrix branch: minpix and final_gid moved past 2^24 come back
    exactly; both branches give the same labels on the plain ids."""
    costs = torch.as_tensor(np.random.default_rng(2).integers(
        -8, 9, size=(2, 32, 64, 2)).astype(np.float32))
    res = th.hier_gaec(costs, caps=[64, 32, 32], rounds_per_level=[2, 1],
                       agg=agg)
    labels = th.smallest_pixel_labels(res)
    assert int(res.overflow.sum()) > 0  # frozen regions carry final_gid
    if agg == "pixel":
        res_m = th.hier_gaec(costs, caps=[64, 32, 32],
                             rounds_per_level=[2, 1], agg="matrix")
        assert torch.equal(labels, th.smallest_pixel_labels(res_m))
        return
    sentinel = 32 * 64
    big = res._replace(
        minpix=torch.where(res.minpix < sentinel, _big(res.minpix),
                           _big(torch.tensor(sentinel))).to(torch.int32),
        final_gid=_big(res.final_gid).to(torch.int32))
    got = th.smallest_pixel_labels(big)
    assert got.dtype == torch.int32
    assert torch.equal(got, _big(labels).to(torch.int32))
