"""The reader `load_ready_images` on a snapshot that the program's tracing
module fills through its own `span` and `count`: the counter over the
compress batches in a compress cell, None in an RL cell and where the
program counted nothing (a program without the counter)."""

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
    return harness.reader("load_ready_images")({"driver": driver})


def test_load_ready_images():
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity
                                            .CPU]):
        for b, ready in enumerate((0, 8, 5)):
            with span("compress.batch", "cpu", id=b):
                with span("load"):
                    count("load.ready_images", ready)
    assert _read("compress") == pytest.approx(13 / 3)
    assert _read("rl") is None


def test_load_ready_images_not_counted():
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity
                                            .CPU]):
        with span("compress.batch", "cpu", id=0):
            with span("load"):
                pass
    assert _read("compress") is None
