"""CUDA kernels of the PyTorch port against their plain versions, on the
card. Every test here needs a CUDA GPU and skips without one. This file
imports no JAX, so it runs on a machine without the reference's
dependencies:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from image_compression_torch.ops import multicut_leaf as leaf
from image_compression_torch.ops.multicut import multicut_grid

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels run only on the card")
    return torch.device("cuda")


def _costs(kind, shape=(2, 64, 64)):
    rng = np.random.default_rng(3)
    if kind == "heavy":
        return (-np.abs(rng.normal(size=shape + (2,))) - 0.1).astype(
            np.float32)
    return rng.integers(-8, 9, size=shape + (2,)).astype(np.float32)


@pytest.mark.parametrize("kind,s1,shape", [
    ("int", 64, (2, 64, 64)), ("int", 128, (2, 64, 64)),
    ("heavy", 64, (2, 64, 64)), ("int", 64, (3, 48, 48))])
def test_leaf_kernel_matches_plain(cuda, kind, s1, shape):
    """Every output bitwise equal to the plain version on integer costs and
    the heavy-freezing recipe, also on a ragged batch (3 x 48x48: 27
    supertiles); one launch counted per call."""
    args = (*leaf.leaf_inputs(torch.as_tensor(_costs(kind, shape),
                                              device=cuda)),
            s1, 2, 1, shape[1] * shape[2])
    before = leaf.launches
    got = leaf.leaf_cuda(*args)
    assert leaf.launches == before + 1
    for g, w in zip(got, leaf.leaf_plain(*args)):
        assert g.shape == w.shape and torch.equal(g, w)


def test_leaf_kernel_rejects_bad_inputs(cuda):
    w0h, w0v, wmid, pix = leaf.leaf_inputs(
        torch.as_tensor(_costs("int"), device=cuda))
    with pytest.raises(ValueError, match="f32"):
        leaf.leaf_cuda(w0h.double(), w0v, wmid, pix, 64, 2, 1, 64 * 64)
    with pytest.raises(ValueError, match="s1"):
        leaf.leaf_cuda(w0h, w0v, wmid, pix, 256, 2, 1, 64 * 64)


def test_leaf_kernel_repeats_on_real_costs(cuda):
    """No float atomics: two launches on real-valued costs agree bit for
    bit."""
    rng = np.random.default_rng(4)
    costs = torch.as_tensor(rng.normal(size=(2, 64, 64, 2)).astype(
        np.float32), device=cuda)
    args = (*leaf.leaf_inputs(costs), 64, 2, 1, 64 * 64)
    for a, b in zip(leaf.leaf_cuda(*args), leaf.leaf_cuda(*args)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("shape", [(3, 64, 64), (2, 96, 160)])
def test_solver_on_card_equals_cpu(cuda, shape):
    """multicut_grid through the kernel gives the CPU plain path's labels,
    also where sorted rounds finish a non-square image."""
    costs = torch.as_tensor(_costs("int", shape))
    kw = dict(hier_rounds=(2, 1), hier_caps="flat64")
    before = leaf.launches
    on_card = multicut_grid(costs.to(cuda), **kw)
    assert leaf.launches == before + 1
    assert torch.equal(on_card.cpu(), multicut_grid(costs, **kw))


def test_solver_repeats_on_real_costs(cuda):
    """The sorted finishing rounds sum pair costs in a fixed order: two
    solves of real-valued costs on a non-square batch give the same
    labels."""
    costs = torch.as_tensor(np.random.default_rng(5).normal(
        size=(2, 96, 160, 2)).astype(np.float32), device=cuda)
    kw = dict(hier_rounds=(2, 1), hier_caps="flat64")
    assert torch.equal(multicut_grid(costs, **kw), multicut_grid(costs, **kw))


@pytest.mark.parametrize("shape,kw", [
    ((4, 12, 12), {}), ((2, 8, 40), {}),
    ((2, 64, 64), dict(mode="random_mate", icm_sweeps=8, hier_agg="pixel")),
    ((2, 64, 64), dict(mode="mutual")), ((2, 64, 64), dict(mode="hybrid")),
    ((2, 48, 80), dict(mode="random_mate", hier_agg="matrix"))])
def test_solver_configurations_on_card_equal_cpu(cuda, shape, kw):
    """The tiny-grid ensemble, ICM, pixel aggregation, the sorted path's
    modes with the tile presolve and the random-mate hierarchy give the
    CPU's labels on integer costs."""
    costs = torch.as_tensor(_costs("int", shape))
    assert torch.equal(multicut_grid(costs.to(cuda), **kw).cpu(),
                       multicut_grid(costs, **kw))


def test_coin_bits_on_card_equal_cpu(cuda):
    from image_compression_torch.ops import prng
    for salt in (0, 50_003, 2 ** 31 - 1):
        key = prng.fold_in(prng.prng_key(2), salt)
        assert torch.equal(prng.random_bits(key, (77, 256), cuda).cpu(),
                           prng.random_bits(key, (77, 256)))
