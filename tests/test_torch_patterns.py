"""Pattern generators of the PyTorch port (utils/pattern_generator.py) vs
the reference's: for the same np.random.Generator state every generator
gives the same pixels, labels and generator state afterwards, bitwise
(tolerance: none)."""

import numpy as np
import pytest

from image_compression_tpu.utils import pattern_generator as jp
from image_compression_torch.utils import pattern_generator as tp


def _same(a, b):
    for x, y in zip(a if isinstance(a, tuple) else (a,),
                    b if isinstance(b, tuple) else (b,)):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("name", sorted(jp.GENERATORS))
@pytest.mark.parametrize("alpha", [False, True])
def test_generators_bitwise(name, alpha):
    assert sorted(tp.GENERATORS) == sorted(jp.GENERATORS)
    ref_rng, rng = np.random.default_rng(5), np.random.default_rng(5)
    for h, w in ((32, 32), (23, 41)):
        _same(jp.GENERATORS[name](w, h, alpha, ref_rng),
              tp.GENERATORS[name](w, h, alpha, rng))
    assert ref_rng.bit_generator.state == rng.bit_generator.state


@pytest.mark.parametrize("name", sorted(jp.MOSAIC_GENERATORS))
def test_mosaic_generators_bitwise(name):
    """The corpus classes (cells 64 and 128 where they take a cell) at
    256x256 and a ragged 96x160."""
    assert sorted(tp.MOSAIC_GENERATORS) == sorted(jp.MOSAIC_GENERATORS)
    ref_rng, rng = np.random.default_rng(0), np.random.default_rng(0)
    kws = [{}]
    if name in ("sigma_mosaic", "anticorr_mosaic", "mixed_mosaic"):
        kws = [dict(cell=64), dict(cell=128)]
    for size in ((256, 256), (160, 96)):
        for kw in kws:
            _same(jp.MOSAIC_GENERATORS[name](*size, ref_rng, **kw),
                  tp.MOSAIC_GENERATORS[name](*size, rng, **kw))
    assert ref_rng.bit_generator.state == rng.bit_generator.state


@pytest.mark.parametrize("h,w,k,seed", [(32, 32, 5, 0), (17, 40, 9, 3)])
def test_random_partition_bitwise(h, w, k, seed):
    _same(jp.generate_random_partition(h, w, k, seed),
          tp.generate_random_partition(h, w, k, seed))
