"""Small CPU versions of the cells for the tests: the cell's own
configuration and limits, its traffic at 32 x 32 (by default) with cells of
a quarter and a half of the side."""

from __future__ import annotations

import copy

from portbench import harness


def spec(cell: str, images: int | None = None, size: int = 32) -> dict:
    s = copy.deepcopy(harness.cell_spec(cell))
    driver = s["config"]["driver"]
    s["traffic"] = dict(s["traffic"], size=size, cells=[size // 4,
                                                        size // 2],
                        images=images or (8 if driver == "compress" else 32))
    if "image_size" in s["config"]["settings"]:
        s["config"]["settings"]["image_size"] = size
    return s


def run(cell: str, seed: int = 4, seconds: float = 1.0,
        trace: bool = False, size: int = 32) -> dict:
    import torch
    torch.set_num_threads(2)
    return harness.run_cell(cell, seed, seconds, trace, device="cpu",
                            spec=spec(cell, size=size))
