"""Frozen copy of the port's `ops/multicut.py` (plain PyTorch), part of the
benchmark's reference; it imports nothing of the program.

Grid multicut: greedy additive edge contraction (GAEC) on the
4-connected pixel grid of each image of a batch, on the path that the
benchmark's configurations run: the dense hierarchy
(reference/multicut_hier.py) in chain mode with slot-space "matrix"
aggregation, levels 0-1 in the multicut leaf, no ICM, on square images
whose top supertile covers the image. Any other setting raises: the port's
tiny-grid ensemble, padding, sorted rounds, tile presolve, other modes,
pixel aggregation and ICM are not copied. A configuration that needs one
copies that path in with a test of its own.

Edge-cost convention: positive = attraction ("connect"), negative =
repulsion ("cut"). Every region is labelled by its smallest flat pixel
index (the minlabel contract).
"""

from __future__ import annotations

import torch

from portbench.reference.multicut_hier import (
    default_caps, flat64_caps, hier_gaec, plan_levels, smallest_pixel_labels)


def multicut_grid(costs_bhw2: torch.Tensor, max_rounds: int = 3,
                  mode: str = "chain", icm_sweeps: int = 0,
                  matchings_per_round: int = 4,
                  hier_rounds: tuple[int, ...] | None = None,
                  hier_caps: tuple[int, ...] | str | None = None,
                  hier_agg: str = "matrix", hier_leaf: str = "auto"):
    """Solve multicut on the 4-connected grid of each image of a batch.

    Takes the port's arguments under its names; `max_rounds` and
    `matchings_per_round` belong to the sorted rounds, which never run on
    this path. costs_bhw2: [B, H, W, 2] float edge costs (padding slots
    ignored). hier_rounds: rounds per level (default (3, 2, 1, ...));
    hier_caps: slot caps per level, "flat64" or None (`default_caps`).
    Returns labels [B, H, W] int32."""
    if (mode, icm_sweeps, hier_agg, hier_leaf) != ("chain", 0, "matrix",
                                                   "auto"):
        raise ValueError(
            "the reference follows mode 'chain', icm_sweeps 0, hier_agg "
            f"'matrix', hier_leaf 'auto'; got {mode!r}, {icm_sweeps}, "
            f"{hier_agg!r}, {hier_leaf!r}")
    sides = plan_levels(*costs_bhw2.shape[1:3], 8)
    if hier_caps == "flat64":
        caps = flat64_caps(sides)
    elif hier_caps is None:
        caps = default_caps(sides)
    elif isinstance(hier_caps, str):
        raise ValueError(f"the reference has no caps preset {hier_caps!r}")
    else:
        caps = hier_caps
    res = hier_gaec(costs_bhw2, hier_rounds or (3, 2, 1), caps)
    return smallest_pixel_labels(res)
