"""Dense tile-level GAEC presolve of the sorted multicut path.

Port of the reference's ops/multicut_tiles.py. The sorted path (mutual and
hybrid modes, `hier=False` solves) first contracts within tiles of side
`tile`, where a tile's region-pair cost matrix [S, S] (S = tile^2) is small
enough to hold densely: pair aggregation is a one-hot matrix product, the
best partner a first-index row maximum. Then `boundary_edges` lists the
tile-crossing edges for sorted boundary rounds (ops/multicut.py).

The rounds are random-mate: mutual best pairs always, tail -> head hooks by
the coins `fold_in(PRNGKey(2), round)` of shape [tiles of one image, S],
repeated over the batch. Pair costs are summed in f32 from unrounded
weights; the reference's one-hot lookups of ids (< S) and 0/1 coins are
gathers here (bitwise for those values).
"""

from __future__ import annotations

import numpy as np
import torch

from image_compression_torch.ops import prng
from image_compression_torch.ops.multicut_hier import (_pair_matrix, _take,
                                                       first_argmax)


def _tile_local_edges(tile: int) -> tuple[np.ndarray, np.ndarray]:
    """Intra-tile edge endpoints in local ids [0, tile^2): horizontal edges
    row-major, then vertical (the layout of `_tile_weights`)."""
    ys, xs = np.mgrid[0:tile, 0:tile]
    base = (ys * tile + xs).astype(np.int32)
    u_h = base[:, :-1].reshape(-1)
    v_h = (base[:, :-1] + 1).reshape(-1)
    u_v = base[:-1, :].reshape(-1)
    v_v = (base[:-1, :] + tile).reshape(-1)
    return np.concatenate([u_h, u_v]), np.concatenate([v_h, v_v])


def _tiles_of(plane: torch.Tensor, tile: int) -> torch.Tensor:
    """[B, H, W] -> [B * T, tile, tile], tiles row-major within each
    image."""
    b, height, width = plane.shape
    return (plane.reshape(b, height // tile, tile, width // tile, tile)
            .permute(0, 1, 3, 2, 4).reshape(-1, tile, tile))


def _tile_weights(costs_bhw2: torch.Tensor, tile: int) -> torch.Tensor:
    """[B, H, W, 2] -> [B * T, Et] intra-tile edge weights, edge order of
    `_tile_local_edges`."""
    ch = _tiles_of(costs_bhw2[..., 0], tile)
    cv = _tiles_of(costs_bhw2[..., 1], tile)
    t_count = ch.shape[0]
    return torch.cat([ch[:, :, :-1].reshape(t_count, -1),
                      cv[:, :-1, :].reshape(t_count, -1)], dim=1)


def tile_presolve(costs_bhw2: torch.Tensor, tile: int = 16,
                  rounds: int = 6) -> torch.Tensor:
    """Intra-tile random-mate GAEC. Returns root [B, H, W] int64 in each
    image's pixel ids (each region's smallest pixel index within its tile).
    H and W must divide by tile."""
    b, height, width = costs_bhw2.shape[:3]
    if height % tile or width % tile:
        raise ValueError(f"tile {tile} must divide {height}x{width}")
    th, tw = height // tile, width // tile
    s = tile * tile
    dev = costs_bhw2.device
    w = _tile_weights(costs_bhw2.to(torch.float32), tile)   # [B*T, Et]
    t_count = w.shape[0]
    ids = torch.arange(s, device=dev).expand(t_count, s)

    def endpoints(root):
        r3 = root.reshape(t_count, tile, tile)
        ru = torch.cat([r3[:, :, :-1].reshape(t_count, -1),
                        r3[:, :-1, :].reshape(t_count, -1)], dim=1)
        rv = torch.cat([r3[:, :, 1:].reshape(t_count, -1),
                        r3[:, 1:, :].reshape(t_count, -1)], dim=1)
        return ru, rv

    root = ids
    for r in range(rounds):
        ru, rv = endpoints(root)
        we = torch.where(ru != rv, w, 0.0)
        pair = _pair_matrix(torch.minimum(ru, rv), torch.maximum(ru, rv),
                            we, s)
        sym = pair + pair.transpose(1, 2)
        best = sym.amax(dim=-1)
        partner = first_argmax(sym, best)
        merge = best > 0.0
        partner_safe = torch.where(merge, partner, 0)
        mutual = merge & (_take(partner, partner_safe) == ids)
        coin = prng.bernoulli(prng.fold_in(prng.prng_key(2), r), 0.5,
                              (th * tw, s), dev).repeat(b, 1)
        merge = mutual | (merge & ~coin & _take(coin, partner_safe))
        nxt = torch.where(merge, partner, ids)
        two_cycle = (_take(nxt, nxt) == ids) & (ids < nxt)
        nxt = torch.where(two_cycle, ids, nxt)
        nxt = _take(nxt, nxt)
        nxt = _take(nxt, nxt)
        root = _take(nxt, root)

    # local roots -> pixel ids of the image
    t_idx = torch.arange(th * tw, device=dev).repeat(b)[:, None]
    gy = (t_idx // tw) * tile + root // tile
    gx = (t_idx % tw) * tile + root % tile
    return ((gy * width + gx).reshape(b, th, tw, tile, tile)
            .permute(0, 1, 3, 2, 4).reshape(b, height, width))


def boundary_edges(height: int, width: int,
                   tile: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Static (u, v, plane_slot) of the grid edges crossing tile
    boundaries; plane_slot indexes the flattened [H, W, 2] cost layout."""
    ys, xs = np.mgrid[0:height, 0:width]
    base = ys * width + xs
    slot = base * 2  # horizontal plane slot at (y, x)
    h_cross = (xs % tile == tile - 1) & (xs + 1 < width)
    v_cross = (ys % tile == tile - 1) & (ys + 1 < height)
    u = np.concatenate([base[h_cross], base[v_cross]]).astype(np.int32)
    v = np.concatenate([base[h_cross] + 1, base[v_cross] + width]) \
        .astype(np.int32)
    w_slot = np.concatenate([slot[h_cross],
                             slot[v_cross] + 1]).astype(np.int32)
    return u, v, w_slot
