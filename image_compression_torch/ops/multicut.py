"""Grid multicut: greedy additive edge contraction (GAEC) on the
4-connected pixel grid of each image of a batch.

Port of the reference's ops/multicut.py, every branch of `multicut_grid`:

  * the tiny-grid ensemble (a side under 16, chain mode): the sorted path
    solved twice, with chain and with random-mate hooking, keeping per
    image the labels that join the larger cost;
  * the pad-to-32 branch for sides not divisible into two hierarchy levels;
  * the dense hierarchy (ops/multicut_hier.py, chain or random-mate, slot-
    space "matrix" or pixel-space "pixel" aggregation), finished by sorted
    rounds where the top supertile does not cover the image;
  * the sorted path: the tile presolve and boundary rounds
    (ops/multicut_tiles.py) where the sides divide into tiles, then sorted
    rounds over every edge (`_contract_rounds`, all four modes);
  * ICM local moves and `relabel_connected` whenever icm_sweeps > 0.

The batch is a dimension of every tensor ([B, H, W, 2] -> [B, H, W]). The
reference vmaps one image's solve over the batch with constant coin keys, so
every image of a batch draws the same coins: each coin array here is drawn
once at one image's shape and repeated over the batch, and a sorted-round
loop freezes an image once a round leaves it unchanged, as vmap's while
loop does.

Edge-cost convention: positive = attraction ("connect"), negative =
repulsion ("cut"). Labels follow the minlabel contract (every region is
labelled by its smallest flat pixel index) wherever `produces_minlabel`
says so; the tiny-grid and other sorted-path labels with icm_sweeps = 0 are
region roots, as in the reference.
"""

from __future__ import annotations

import numpy as np
import torch

from image_compression_torch.ops import prng
from image_compression_torch.ops.edges import edge_validity_masks
from image_compression_torch.ops.multicut_hier import (
    hier_gaec, lean_caps, plan_levels, smallest_pixel_labels)
from image_compression_torch.ops.multicut_tiles import (boundary_edges,
                                                        tile_presolve)
from image_compression_torch.utils.profiling import span

MODES = ("chain", "mutual", "random_mate", "hybrid")


def multicut_grid(costs_bhw2: torch.Tensor, max_rounds: int = 3,
                  mode: str = "chain", icm_sweeps: int = 0,
                  matchings_per_round: int = 4, tile: int = 16,
                  presolve_rounds: int = 4, boundary_rounds: int = 4,
                  return_rounds: bool = False, hier: bool = True,
                  hier_rounds: tuple[int, ...] | None = None,
                  hier_caps: tuple[int, ...] | str | None = None,
                  hier_agg: str = "matrix", hier_leaf: str = "auto"):
    """Solve multicut on the 4-connected grid of each image of a batch.

    Takes the reference's arguments under its names. Two defaults differ
    from the reference function's: icm_sweeps=0 (reference 8) and
    hier_agg="matrix" (reference "pixel"), the port's compress settings;
    `multicut_grid_batched` keeps the reference's defaults.

    costs_bhw2: [B, H, W, 2] float edge costs (padding slots ignored).
    max_rounds: bound on the sorted rounds over all edges (at least one
      runs where they finish the hierarchy).
    mode: "chain" (hook every region to its best attractive neighbour),
      "mutual" (mutual-best pairs only), "random_mate" (mutual pairs plus
      coin-flipped tail -> head hooks), "hybrid" (chain in the first round
      of each sorted phase, then random_mate). mutual and hybrid run the
      sorted path.
    icm_sweeps: checkerboard local-move sweeps after contraction, followed
      by relabel_connected (0 = neither).
    matchings_per_round: matching passes per sorted cost re-aggregation
      (non-chain rounds).
    tile / presolve_rounds / boundary_rounds: the sorted path's tile
      presolve and boundary rounds, run where both sides exceed `tile` and
      divide by it.
    return_rounds: also return the sorted rounds run per image ([B]).
    hier: use the dense hierarchy where the shape allows it.
    hier_rounds / hier_caps: rounds per level and slot caps of the
      hierarchy (hier_caps may be a `lean_caps` preset name); None uses the
      defaults of ops/multicut_hier.py.
    hier_agg: "matrix" (slot-space pair matrices; levels 0-1 in the
      multicut leaf) or "pixel" (pixel-space re-aggregation each round).
    hier_leaf: "auto" | "fused" | "xla" (= "unfused"), matrix agg only.

    Returns labels [B, H, W] int32 (and rounds [B] int64 with
    return_rounds). Traced, a span "multicut" (a recursive call is part of
    it)."""
    with span("multicut", costs_bhw2.device):
        return _solve(costs_bhw2, max_rounds, mode, icm_sweeps,
                      matchings_per_round, tile, presolve_rounds,
                      boundary_rounds, return_rounds, hier, hier_rounds,
                      hier_caps, hier_agg, hier_leaf)


def _solve(costs_bhw2, max_rounds, mode, icm_sweeps, matchings_per_round,
           tile, presolve_rounds, boundary_rounds, return_rounds, hier,
           hier_rounds, hier_caps, hier_agg, hier_leaf):
    if mode not in MODES:
        raise ValueError(f"unknown mode: {mode}")
    if hier_agg not in ("pixel", "matrix"):
        raise ValueError(f"unknown agg: {hier_agg}")
    if hier_leaf not in ("auto", "fused", "xla", "unfused"):
        raise ValueError(f"unknown leaf: {hier_leaf}")
    b, height, width = costs_bhw2.shape[:3]
    costs = costs_bhw2.to(torch.float32)
    dev = costs.device
    kw = dict(max_rounds=max_rounds, icm_sweeps=icm_sweeps,
              matchings_per_round=matchings_per_round, tile=tile,
              presolve_rounds=presolve_rounds,
              boundary_rounds=boundary_rounds)
    hier_kw = dict(hier_rounds=hier_rounds, hier_caps=hier_caps,
                   hier_agg=hier_agg, hier_leaf=hier_leaf)

    # tiny grids: the sorted path twice, chain and random_mate; keep chain's
    # labels where they join at least as much cost
    if hier and mode == "chain" and not return_rounds \
            and min(height, width) < 16:
        lab_c = multicut_grid(costs, mode="chain", hier=False, **kw)
        lab_r = multicut_grid(costs, mode="random_mate", hier=False, **kw)
        keep_c = _joined(lab_c, costs) >= _joined(lab_r, costs)
        return torch.where(keep_c[:, None, None], lab_c, lab_r)

    sides = plan_levels(height, width, 8) if hier else []
    if (hier and mode in ("chain", "random_mate") and len(sides) < 2
            and min(height, width) >= 16):
        # pad to multiples of 32 with zero-cost edges: the original's
        # padding slots (last column/row) become real edges to padded
        # pixels, so zero them first; padding-to-padding edges get weight 1
        # so the padding collapses into one region per supertile
        ph, pw = -(-height // 32) * 32, -(-width // 32) * 32
        masked = costs * edge_validity_masks(height, width, device=dev)
        ys = torch.arange(ph, device=dev)[:, None]
        xs = torch.arange(pw, device=dev)[None, :]
        pad_pad = ((ys >= height) | (xs >= width)).to(torch.float32)
        padded = pad_pad[None, :, :, None] + torch.nn.functional.pad(
            masked, (0, 0, 0, pw - width, 0, ph - height))
        out = multicut_grid(padded, mode=mode, return_rounds=return_rounds,
                            hier=True, **kw, **hier_kw)
        labels_p, rounds = out if return_rounds else (out, None)
        # labels reference padded pixel indices: restore the minlabel
        # contract in original coordinates
        labels = relabel_connected(labels_p[:, :height, :width])
        return (labels, rounds) if return_rounds else labels

    w_all = costs.reshape(b, -1)
    rounds = torch.zeros(b, dtype=torch.int64, device=dev)
    if len(sides) >= 2 and mode in ("chain", "random_mate"):
        caps = (lean_caps(sides, hier_caps) if isinstance(hier_caps, str)
                else hier_caps)
        res = hier_gaec(costs, mode=mode, rounds_per_level=hier_rounds,
                        caps=caps, agg=hier_agg, leaf=hier_leaf)
        labels = smallest_pixel_labels(res)
        if res.top_tile != height or res.top_tile != width:
            # the top supertile does not cover the image: finish with sorted
            # rounds over the remaining inter-supertile merges on plain
            # pixel-index roots (frozen regions rejoin contraction here; the
            # rounds have no slot caps)
            root, rounds = _contract_rounds(
                relabel_connected(labels).reshape(b, -1), _grid_endpoints,
                w_all, (height, width), max_rounds=max(max_rounds, 1),
                mode=mode, matchings_per_round=matchings_per_round,
                salt_base=90_000)
            labels = root.reshape(b, height, width)
            if icm_sweeps == 0:
                # sorted-round roots are not smallest-pixel ids
                labels = relabel_connected(labels)
    else:
        use_presolve = (tile > 1 and height % tile == 0
                        and width % tile == 0 and height > tile
                        and width > tile and presolve_rounds > 0)
        if use_presolve:
            root = tile_presolve(costs, tile, presolve_rounds).reshape(b, -1)
            if boundary_rounds > 0:
                bu, bv, bslot = (torch.as_tensor(a, device=dev) for a in
                                 boundary_edges(height, width, tile))
                root, _ = _contract_rounds(
                    root, lambda r, _shape: (r[:, bu], r[:, bv]),
                    w_all[:, bslot], (height, width),
                    max_rounds=boundary_rounds, mode=mode,
                    matchings_per_round=matchings_per_round,
                    salt_base=50_000)
        else:
            root = torch.arange(height * width, device=dev).expand(b, -1)
        root, rounds = _contract_rounds(
            root, _grid_endpoints, w_all, (height, width),
            max_rounds=max_rounds, mode=mode,
            matchings_per_round=matchings_per_round, salt_base=0)
        labels = root.reshape(b, height, width)

    if icm_sweeps > 0:
        labels = relabel_connected(_icm_refine(labels, costs, icm_sweeps))
    labels = labels.to(torch.int32)
    return (labels, rounds) if return_rounds else labels


def _joined(labels: torch.Tensor, costs: torch.Tensor) -> torch.Tensor:
    """Summed cost of the joined edges of each image, [B] f32."""
    h = torch.where(labels[:, :, 1:] == labels[:, :, :-1],
                    costs[:, :, :-1, 0], 0.0).sum(dim=(1, 2))
    v = torch.where(labels[:, 1:, :] == labels[:, :-1, :],
                    costs[:, :-1, :, 1], 0.0).sum(dim=(1, 2))
    return h + v


def _grid_endpoints(root: torch.Tensor, shape: tuple[int, int]):
    """Region ids of each edge's endpoints, [B, H * W * 2] each, slot order
    (y, x, plane) by shifts of the root image; the padding slots (last
    column of plane 0, last row of plane 1) get u == v and stay inactive."""
    b = root.shape[0]
    img = root.reshape(b, *shape)
    right = torch.cat([img[:, :, 1:], img[:, :, -1:]], dim=2)
    down = torch.cat([img[:, 1:, :], img[:, -1:, :]], dim=1)
    return (torch.stack([img, img], -1).reshape(b, -1),
            torch.stack([right, down], -1).reshape(b, -1))


def _match(pa, pb, pc, ids, touched, coin, chain: bool, mutual_only: bool,
           last: bool):
    """One matching + contraction pass against the pair table (pa, pb, pc)
    (global region ids, summed costs). Pairs with a touched endpoint sit
    out. Returns (map nxt over the ids, touched)."""
    total = ids.numel()
    if touched is not None:
        act = ~touched[pa] & ~touched[pb]
        pa, pb, pc = pa[act], pb[act], pc[act]
    src = torch.cat([pa, pb])
    dst = torch.cat([pb, pa])
    val = torch.cat([pc, pc])
    best = torch.full((total,), float("-inf"), device=ids.device
                      ).scatter_reduce(0, src, val, "amax")
    is_best = val == best[src]
    partner = torch.full_like(ids, total).scatter_reduce(
        0, src, torch.where(is_best, dst, total), "amin")
    merge = (best > 0.0) & (partner < total)
    partner_safe = torch.where(merge, partner, 0)
    mutual = merge & (partner[partner_safe] == ids)
    if not chain:  # random-mate: mutual pairs, tails hook into heads
        merge = mutual | (merge & ~coin & coin[partner_safe])
    if mutual_only:
        merge = mutual
    nxt = torch.where(merge, partner, ids)
    two_cycle = (nxt[nxt] == ids) & (ids < nxt)
    nxt = torch.where(two_cycle, ids, nxt)
    # two doublings (depth 4): deeper chains finish contracting in the next
    # round, their intermediate ids acting as region ids meanwhile
    for _ in range(2):
        nxt = nxt[nxt]
    if last:
        return nxt, touched
    # a region is touched if it merged away or something merged into it
    received = torch.zeros_like(merge)
    received[partner_safe[merge]] = True
    base = merge if touched is None else touched | merge
    return nxt, base | received


def _contract_rounds(root: torch.Tensor, endpoints, w: torch.Tensor,
                     shape: tuple[int, int], *, max_rounds: int, mode: str,
                     matchings_per_round: int, salt_base: int):
    """Sorted GAEC rounds over a static edge list (the reference's
    `_contract_rounds`).

    root [B, n] region ids (pixel indices of each image); endpoints(root,
    shape) -> (ru, rv) [B, E] region ids of each edge's endpoints; w [B, E]
    edge costs. Returns (root [B, n] int64, rounds run per image [B]).

    Per round: canonical pairs (min, max) of the active edges and their
    costs summed in a fixed order (stable sort, then one segmented sum per
    pair), then matching passes against that table. A chain pass hooks each
    region to its best partner (the maximum over its pairs, ties to the
    smallest id) iff best > 0; a random-mate pass keeps mutual pairs and
    the tail -> head hooks of per-pass coins `fold_in(PRNGKey(0), salt_base
    + round * matchings_per_round + pass)`; a mutual pass keeps mutual
    pairs. Non-chain rounds run `matchings_per_round` passes, each over the
    pairs untouched by the earlier passes; hybrid runs chain in round 0.
    Every pass breaks 2-cycles toward the smaller id and makes exactly two
    pointer doublings.

    The batch runs as one graph (image i's ids offset by i * n); an image
    whose round changed nothing, or that ran max_rounds rounds, is done and
    its edges leave the table, as the reference's vmapped while loop stops
    it."""
    b, n = root.shape
    total = b * n
    dev = root.device
    offset = (torch.arange(b, device=dev) * n)[:, None]
    root = root.to(torch.int64) + offset
    w = w.to(torch.float32)
    ids = torch.arange(total, device=dev)
    done = torch.zeros(b, dtype=torch.bool, device=dev)
    rounds = torch.zeros(b, dtype=torch.int64, device=dev)
    for it in range(max_rounds):
        rounds += (~done).long()
        # --- aggregate costs per adjacent region pair ---------------------
        ru, rv = endpoints(root, shape)
        active = (ru != rv) & ~done[:, None]
        lo = torch.minimum(ru, rv)[active]
        hi = torch.maximum(ru, rv)[active]
        if lo.numel() == 0:  # nothing can merge: every image is done
            break
        # a stable sort keeps each pair's edges in slot order and the
        # segmented sum adds them in that order without atomics, so the
        # totals repeat bit for bit on real-valued costs too
        key = lo * total + hi
        order = torch.argsort(key, stable=True)
        keys, counts = torch.unique_consecutive(key[order],
                                                return_counts=True)
        pc = torch.segment_reduce(w[active][order], "sum", lengths=counts)
        pa, pb = keys // total, keys % total

        # --- matching passes against this table ---------------------------
        if mode == "chain" or (mode == "hybrid" and it == 0):
            m, _ = _match(pa, pb, pc, ids, None, None, True, False, True)
        else:
            m, touched = ids, None
            for k in range(matchings_per_round):
                salt = salt_base + it * matchings_per_round + k
                coin = prng.bernoulli(
                    prng.fold_in(prng.prng_key(0), salt), 0.5, (n,),
                    dev).repeat(b)
                nxt, touched = _match(pa, pb, pc, ids, touched, coin, False,
                                      mode == "mutual",
                                      k == matchings_per_round - 1)
                m = nxt[m]
        new_root = m[root]
        done |= ~(new_root != root).any(dim=1)
        root = new_root
        if bool(done.all()):
            break
    return root - offset, rounds


def _icm_refine(labels: torch.Tensor, costs: torch.Tensor,
                sweeps: int) -> torch.Tensor:
    """Checkerboard iterated-conditional-modes refinement (the reference's
    `_icm_refine`): each pixel of the active parity adopts the neighbour
    label with the largest gain in joined cost, if that gain exceeds 1e-6;
    all its neighbours are frozen within the half-sweep. labels [B, H, W],
    costs [B, H, W, 2]."""
    b, height, width = labels.shape
    dev = labels.device
    w_h = costs[..., 0].clone()
    w_h[:, :, width - 1] = 0.0    # weight to the right neighbour
    w_v = costs[..., 1].clone()
    w_v[:, height - 1, :] = 0.0   # weight to the down neighbour
    w_left = torch.nn.functional.pad(w_h, (1, 0))[:, :, :-1]
    w_up = torch.nn.functional.pad(w_v, (0, 0, 1, 0))[:, :-1, :]
    weights = (w_h, w_left, w_v, w_up)
    parity = ((torch.arange(height, device=dev)[:, None]
               + torch.arange(width, device=dev)[None, :]) % 2)

    def half_sweep(lab, active_parity):
        big = torch.nn.functional.pad(lab, (1, 1, 1, 1), value=-1)
        nb = (big[:, 1:-1, 2:], big[:, 1:-1, :-2],   # right, left
              big[:, 2:, 1:-1], big[:, :-2, 1:-1])   # down, up

        def attachment(candidate):
            # sum of w(p, q) over neighbours q currently labelled candidate
            acc = torch.zeros_like(w_h)
            for q_lab, w_pq in zip(nb, weights):
                acc = acc + torch.where(q_lab == candidate, w_pq, 0.0)
            return acc

        stay = attachment(lab)
        best_gain = torch.zeros_like(stay)
        best_lab = lab
        for cand in nb:
            gain = torch.where(cand >= 0, attachment(cand) - stay,
                               float("-inf"))
            take = gain > best_gain
            best_gain = torch.where(take, gain, best_gain)
            best_lab = torch.where(take, cand, best_lab)
        move = (parity == active_parity) & (best_gain > 1e-6)
        return torch.where(move, best_lab, lab)

    lab = labels.to(torch.int64)
    for _ in range(sweeps):
        lab = half_sweep(lab, 0)
        lab = half_sweep(lab, 1)
    return lab


def _seg_min_scan(root: torch.Tensor, reset: torch.Tensor, dim: int,
                  reverse: bool) -> torch.Tensor:
    """Segmented running minimum along `dim` (a segment starts where
    `reset` is set), by log-step doubling — the associative scan of the
    reference, exact because min is."""
    if reverse:
        root, reset = root.flip(dim), reset.flip(dim)
    n = root.shape[dim]
    val, flag = root, reset
    d = 1
    while d < n:
        prev_v = val.narrow(dim, 0, n - d)
        prev_f = flag.narrow(dim, 0, n - d)
        cur_v = val.narrow(dim, d, n - d)
        cur_f = flag.narrow(dim, d, n - d)
        new_v = torch.where(cur_f, cur_v, torch.minimum(prev_v, cur_v))
        val = torch.cat([val.narrow(dim, 0, d), new_v], dim)
        flag = torch.cat([flag.narrow(dim, 0, d), prev_f | cur_f], dim)
        d *= 2
    return val.flip(dim) if reverse else val


def relabel_connected(labels: torch.Tensor,
                      max_rounds: int = 64) -> torch.Tensor:
    """Split disconnected clusters into connected components and relabel
    every cluster by its smallest pixel index. labels [B, H, W] -> int32.

    Segmented min-scans sweep the root ids along rows and columns (label
    boundaries reset the scan), iterated to a fixpoint or `max_rounds`
    sweeps, as the reference does."""
    b, height, width = labels.shape
    same_row = torch.nn.functional.pad(labels[:, :, 1:] == labels[:, :, :-1],
                                       (1, 0))
    same_col = torch.nn.functional.pad(labels[:, 1:, :] == labels[:, :-1, :],
                                       (0, 0, 1, 0))
    end_row = torch.roll(same_row, -1, dims=2)
    end_row[:, :, -1] = False
    end_col = torch.roll(same_col, -1, dims=1)
    end_col[:, -1, :] = False
    root = (torch.arange(height * width, dtype=torch.int32,
                         device=labels.device)
            .reshape(1, height, width).expand(b, height, width))
    for _ in range(max_rounds):
        r = _seg_min_scan(root, ~same_row, 2, reverse=False)
        r = _seg_min_scan(r, ~end_row, 2, reverse=True)
        r = _seg_min_scan(r, ~same_col, 1, reverse=False)
        r = _seg_min_scan(r, ~end_col, 1, reverse=True)
        changed = bool((r != root).any())
        root = r
        if not changed:
            break
    return root.to(torch.int32)


def multicut_grid_batched(costs_bhw2: torch.Tensor, max_rounds: int = 3,
                          mode: str = "chain",
                          icm_sweeps: int = 8) -> torch.Tensor:
    """Batched multicut [B, H, W, 2] -> [B, H, W] int32 with the reference
    function's defaults (8 ICM sweeps, pixel aggregation, default rounds
    and caps)."""
    return multicut_grid(costs_bhw2, max_rounds=max_rounds, mode=mode,
                         icm_sweeps=icm_sweeps, hier_agg="pixel")


def produces_minlabel(height: int, width: int, mode: str,
                      icm_sweeps: int, hier: bool = True) -> bool:
    """True when multicut_grid's labels satisfy the smallest-pixel-index
    contract for these settings and shape: always after ICM (the final
    relabel re-roots every region); without it only on the hierarchy's
    branches, which the grid reaches for chain or random_mate with both
    sides at least 16. The tiny-grid and other sorted-path labels are
    region roots."""
    if icm_sweeps > 0:
        return True
    return hier and mode in ("chain", "random_mate") \
        and min(height, width) >= 16


def multicut_upper_bound(costs_bhw2: torch.Tensor) -> torch.Tensor:
    """Cycle-packing upper bound on the joined-edge objective of each image,
    [B] f32 (the reference's `multicut_upper_bound`): the sum of the
    positive costs less the best of the four parity packings of the unit
    squares with exactly one repulsive edge, each of which loses at least
    min(smallest positive cost in it, |negative cost|)."""
    b, height, width = costs_bhw2.shape[:3]
    costs = costs_bhw2.to(torch.float32)
    wh = costs[:, :, :width - 1, 0]          # [B, H, W-1] horizontal edges
    wv = costs[:, :height - 1, :, 1]         # [B, H-1, W] vertical edges
    ub0 = (wh.clamp(min=0.0).sum(dim=(1, 2))
           + wv.clamp(min=0.0).sum(dim=(1, 2)))
    e = torch.stack([wh[:, :height - 1, :], wh[:, 1:, :],
                     wv[:, :, :width - 1], wv[:, :, 1:]], dim=-1)
    neg = e < 0.0
    conflicted = neg.sum(dim=-1) == 1
    min_pos = torch.where(neg, float("inf"), e).amin(dim=-1)
    neg_mag = -e.clamp(max=0.0).sum(dim=-1)
    loss = torch.where(conflicted, torch.minimum(min_pos, neg_mag), 0.0)
    ys = torch.arange(height - 1, device=costs.device)[:, None]
    xs = torch.arange(width - 1, device=costs.device)[None, :]
    packs = torch.stack([
        torch.where((ys % 2 == py) & (xs % 2 == px), loss, 0.0).sum(
            dim=(1, 2)) for py in (0, 1) for px in (0, 1)], dim=-1)
    return ub0 - packs.amax(dim=-1)


def multicut_objective(costs_hw2: np.ndarray, labels_hw: np.ndarray) -> float:
    """Sum of the costs of joined edges (GAEC maximizes this); host helper
    for checks."""
    costs = np.asarray(costs_hw2)
    labels = np.asarray(labels_hw)
    same_h = labels[:, :-1] == labels[:, 1:]
    same_v = labels[:-1, :] == labels[1:, :]
    return float((costs[:, :-1, 0] * same_h).sum()
                 + (costs[:-1, :, 1] * same_v).sum())


def brute_force_multicut(costs_hw2: np.ndarray) -> tuple[np.ndarray, float]:
    """Exact optimum of one image's multicut by enumerating every set
    partition (restricted-growth strings); test oracle for at most 10
    pixels. Returns (labels [H, W], objective)."""
    costs = np.asarray(costs_hw2)
    height, width = costs.shape[:2]
    n = height * width
    if n > 10:
        raise ValueError("brute force limited to <= 10 nodes")
    edges = []
    for y in range(height):
        for x in range(width):
            if x + 1 < width:
                edges.append((y * width + x, y * width + x + 1,
                              float(costs[y, x, 0])))
            if y + 1 < height:
                edges.append((y * width + x, (y + 1) * width + x,
                              float(costs[y, x, 1])))
    best_obj, best_assign = -np.inf, None

    def rec(i, assign, k):
        nonlocal best_obj, best_assign
        if i == n:
            obj = sum(w for (u, v, w) in edges if assign[u] == assign[v])
            if obj > best_obj:
                best_obj, best_assign = obj, assign.copy()
            return
        for c in range(k + 1):
            assign[i] = c
            rec(i + 1, assign, max(k, c + 1))

    rec(0, [0] * n, 0)
    return np.asarray(best_assign).reshape(height, width), best_obj
