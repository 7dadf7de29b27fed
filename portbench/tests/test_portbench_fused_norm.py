"""The reader `fused_norm_share` on a snapshot that the program's tracing
module fills through its own `span` and `count`: the kernel's share of the
U-Net's norms over the compress batches in a compress cell, None in an RL
cell, where no U-Net ran and where the program counted nothing (a program
without the counters)."""

import pytest
import torch

from portbench import harness
from image_compression_torch.utils import profiling
from image_compression_torch.utils.profiling import count, span


@pytest.fixture(autouse=True)
def fresh():
    profiling.reset()
    yield
    profiling.reset()


def _read(driver):
    return harness.reader("fused_norm_share")({"driver": driver})


def _job(norms):
    """A traced job of one compress batch per entry of `norms`: (norms,
    norms the kernel ran, or None where the program does not count it)."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity
                                            .CPU]):
        for b, (total, fused) in enumerate(norms):
            with span("compress.batch", "cpu", id=b):
                with span("costs"):
                    if total is not None:
                        count("unet.norms", total)
                    if fused is not None:
                        count("unet.norms_fused", fused)


def test_fused_norm_share():
    _job([(14, 14), (14, 7)])
    assert _read("compress") == pytest.approx(100 * 21 / 28)
    assert _read("rl") is None


def test_fused_norm_share_zero_on_the_cpu():
    _job([(14, 0), (14, 0)])
    assert _read("compress") == 0.0


@pytest.mark.parametrize("norms", [[(None, None)], [(0, 0)]],
                         ids=["not counted", "no U-Net"])
def test_fused_norm_share_nothing_to_read(norms):
    _job(norms)
    assert _read("compress") is None
