"""Spatial sharding of one high-resolution image: height strips over a
mesh, with halo exchange for stencils and the strip handoff of the
hierarchical multicut.

Port of the reference's parallel/spatial.py (shard_map + ppermute over the
"data" axis). Here a strip is a tensor on its mesh device: the halo rows
are copies between devices (`.to(device, non_blocking=True)`), the gather
is a concatenation on devices[0], and strips that share a device run as
one batch. Everything is plain torch; inside each strip the solver's
levels 0-1 run in the multicut leaf kernel (agg="matrix", chain mode),
as the reference's strips ran its Pallas leaf.
"""

from __future__ import annotations

from typing import Callable

import torch

from image_compression_torch.ops.canny import canny_edge_costs
from image_compression_torch.ops.multicut_hier import (default_caps,
                                                       hier_gaec, lean_caps,
                                                       plan_levels,
                                                       smallest_pixel_labels)
from image_compression_torch.parallel.mesh import Mesh, shard_batch


def exchange_halo(tiles: list[torch.Tensor], halo: int) -> list[torch.Tensor]:
    """Pad each height strip [h_loc, W, ...] of `tiles` (in row order, each
    on its own device) with `halo` rows of its neighbours; at the image's
    top and bottom the edge row is repeated (as pad mode "edge")."""
    n = len(tiles)
    out = []
    for i, tile in enumerate(tiles):
        dev = tile.device
        top = (tiles[i - 1][-halo:].to(dev, non_blocking=True) if i > 0
               else tile[:1].expand(halo, *tile.shape[1:]))
        bottom = (tiles[i + 1][:halo].to(dev, non_blocking=True)
                  if i < n - 1 else tile[-1:].expand(halo, *tile.shape[1:]))
        out.append(torch.cat([top, tile, bottom], dim=0))
    return out


def halo_map(fn: Callable, mesh: Mesh, halo: int) -> Callable:
    """Lift a stencil `fn(strip_with_halo) -> out_with_halo` into a
    height-sharded function of [H, W, ...] tensors: the image is split into
    mesh.size strips (strip i on devices[i]), padded by exchange_halo, fn
    runs on each, the halo rows are cropped and the strips concatenated on
    devices[0]. A stencil of radius <= halo computes exactly the unsharded
    result."""
    def wrapped(x: torch.Tensor) -> torch.Tensor:
        padded = exchange_halo(shard_batch(mesh, x), halo)
        outs = [fn(t)[halo:t.shape[0] - halo] for t in padded]
        return torch.cat([o.to(mesh.devices[0], non_blocking=True)
                          for o in outs], dim=0)
    return wrapped


def multicut_grid_spatial(costs_hw2: torch.Tensor, mesh: Mesh,
                          mode: str = "chain", rounds_per_level=None,
                          caps=None, agg: str = "pixel") -> torch.Tensor:
    """The hierarchical multicut of one image [H, W, 2] with its strip-local
    levels sharded by height over the mesh -> labels [H, W] int32 on
    devices[0].

    Levels whose supertile side divides the strip height never see an edge
    across a strip (the hierarchy zeroes supertile-crossing edges), so each
    strip runs them alone (`caps_full[:n_local]`); strips on one device run
    as one batch. Frozen regions and min-pixel ids move to global int32 ids
    (plus strip * h_loc * W), the state is gathered on devices[0] in
    row-major tile order (strips are consecutive row blocks), and the
    coarser levels continue there through hier_gaec's start_level /
    init_state; agg="matrix" hands over the strips' pair matrices and
    min-pixel ids as they are (the 7-tuple), so no pixel-space rebuild
    runs. In chain mode the labels equal the unsharded solve's
    (multicut_grid with icm_sweeps=0) bit for bit. In random_mate mode each
    strip draws the coins of a strip-sized image, as the reference's
    sharded solve does, so its labels are the reference's sharded ones,
    not its unsharded ones.

    Requires: H divisible by mesh.size, strip height divisible by 8, and a
    hierarchy whose top tile covers the image (square power-of-two sides).
    """
    height, width = costs_hw2.shape[:2]
    n_strips = mesh.size
    h_loc = height // n_strips
    if height % n_strips or h_loc % 8:
        raise ValueError(f"height {height} not shardable over {n_strips}")
    sides = plan_levels(height, width, 8)
    if not sides or sides[-1] != height or height != width:
        raise ValueError("spatial multicut needs a hierarchy covering the "
                         f"image; got sides={sides} for {height}x{width}")
    if isinstance(caps, str):
        caps = lean_caps(sides, caps)
    caps_full = list(caps) if caps is not None else default_caps(sides)
    n_local = len(plan_levels(h_loc, width, 8))  # strictly strip-local
    rpl = list(rounds_per_level) if rounds_per_level is not None else None
    if rpl is None:  # hier_gaec's default schedule of the whole image
        rpl = ([3, 2] + [1] * (len(sides) - 2) if mode == "chain"
               else [4, 3] + [2] * (len(sides) - 2))
    matrix = agg == "matrix"

    strips = shard_batch(mesh, costs_hw2.to(torch.float32))
    by_device: dict = {}
    for i, d in enumerate(mesh.devices):
        by_device.setdefault(d, []).append(i)
    home = mesh.devices[0]
    parts: list = [None] * n_strips
    for dev, idx in by_device.items():
        res = hier_gaec(torch.stack([strips[i] for i in idx]), mode=mode,
                        rounds_per_level=rpl[:n_local],
                        caps=caps_full[:n_local], agg=agg)
        offset = (torch.tensor(idx, dtype=torch.int32, device=dev)
                  * (h_loc * width))
        gid = torch.where(res.frozen, res.final_gid + offset[:, None, None],
                          0)
        fields = [res.rank_img, res.n_regions, res.frozen, gid,
                  res.overflow]
        if matrix:
            # live slots shift by the strip's first pixel id; dead slots
            # take the whole image's sentinel H*W
            fields += [res.pair, torch.where(
                res.minpix < h_loc * width,
                res.minpix + offset[:, None, None], height * width)]
        for j, i in enumerate(idx):
            parts[i] = [f[j].to(home, non_blocking=True) for f in fields]

    rank_img, ncand, frozen, gid = (torch.cat([p[k] for p in parts])[None]
                                    for k in range(4))
    overflow = torch.stack([p[4] for p in parts]).sum()[None]
    state = (rank_img, ncand, frozen, gid, overflow)
    if matrix:
        state += tuple(torch.cat([p[k] for p in parts])[None]
                       for k in (5, 6))
    res = hier_gaec(costs_hw2.to(home, torch.float32)[None], mode=mode,
                    rounds_per_level=rpl, caps=caps_full,
                    start_level=n_local, init_state=state, agg=agg)
    return smallest_pixel_labels(res)[0]


def sharded_edge_costs(images_hw3: torch.Tensor, mesh: Mesh,
                       halo: int = 8) -> torch.Tensor:
    """Canny edge costs [H, W, 2] of one height-sharded image [H, W, 3];
    halo 8 covers the blur, Sobel, non-maximum suppression and a few
    hysteresis steps, and hysteresis linking beyond the halo stays
    strip-local (the reference's sharded path does the same)."""
    return halo_map(canny_edge_costs, mesh, halo)(images_hw3)
