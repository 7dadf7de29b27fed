"""The work counts of portbench/cost against independent counts."""

import importlib.util

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import harness
from portbench.cost import model as cost


@pytest.mark.parametrize("base,side", [(8, 32), (16, 48)])
def test_unet_flops_match_torch_flop_counter(base, side):
    from image_compression_torch.models.unet import EdgeUNet
    model = EdgeUNet(base=base, dtype=torch.float32).eval()
    x = torch.rand(2, side, side, 3)
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        model(x)
    assert cost.unet_forward_flops(side, side, base) * 2 == \
        counter.get_total_flops()


def test_unet_flops_at_the_flagship_width():
    # ~1.12 MFLOP per pixel at base 64: 73.5 GFLOP per 256^2 image
    assert cost.unet_forward_flops(256, 256, 64) == pytest.approx(
        73.54e9, rel=1e-3)


@pytest.mark.parametrize("t1,s1,r0,r1", [(2048, 64, 2, 1),
                                         (65536, 128, 3, 2)])
def test_leaf_bound_is_chip_smokes(t1, s1, r0, r1):
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", harness.ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    ms, kind = smoke.leaf_bound(t1, s1, r0, r1)
    s, kind2 = cost.leaf_bound_s(t1, s1, r0, r1)
    assert (s * 1e3, kind2) == (pytest.approx(ms), kind)


def test_supertiles():
    assert cost.supertiles(8, 256, 256) == 2048
    assert cost.supertiles(16, 1024, 1024) == 65536
