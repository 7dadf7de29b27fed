"""Frozen copy of the port's `ops/multicut_hier.py` (plain PyTorch), part of the
benchmark's reference; it imports nothing of the program.

Hierarchical dense GAEC: the multicut solver's sort-free path, as the
benchmark's configurations run it (chain mode, slot-space "matrix"
aggregation, levels 0-1 in the multicut leaf); the port's other modes,
pixel aggregation and resumed runs are not copied.

The image is covered by supertiles whose side doubles per level (8 -> 16
-> ... -> min(H, W)); inside a supertile, regions are rank-compacted to a
static slot count S and the aggregated pair-cost matrix [S, S] is dense and
small:

  * a merge round hooks every slot to its most attractive partner (first
    index of the row maximum) where that cost is positive, breaks 2-cycles
    toward the smaller id and contracts chains by three pointer doublings;
  * the pair matrix is the state, P <- M^T P M per round; a level
    transition offsets the four child ranks, freezes the regions that
    overflow the next level's slot cap (labelled by their smallest pixel
    index, from a min-pixel vector m per slot), embeds the four child
    matrices and adds the newly active mid-line edges;
  * pixels carry their region's rank within the current supertile.

Every tensor carries the batch: images are [B, H, W], tile tensors fold the
batch into their leading dimension ([B * tiles, ...], image-major then tiles
row-major). Arithmetic mirrors the reference: edge weights are rounded to
bf16 (round to nearest even) before they are summed in f32, and the argmax
takes the first index. Min-pixel ids are int32. The f32 matrix products
assume PyTorch's default full-precision float32 matmul
(`torch.backends.cuda.matmul.allow_tf32` False).
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

# levels 0-1 fit the leaf when its level-1 slot matrix fits the kernel's
# shared memory (the reference's envelope is caps[1] <= 256; every cap preset
# gives caps[1] <= 128)
LEAF_MAX_S1 = 128


class HierResult(NamedTuple):
    rank_img: torch.Tensor   # [B, H, W] int32 rank in its top tile; -1 frozen
    n_regions: torch.Tensor  # [B, T_top] int32 live regions per top tile
    frozen: torch.Tensor     # [B, H, W] bool: pixel belongs to a frozen region
    final_gid: torch.Tensor  # [B, H, W] int32 where frozen: the region's
    #                          smallest pixel index (minlabel contract)
    overflow: torch.Tensor   # [B] int32 regions frozen per image
    top_tile: int            # side of the top-level supertile
    top_slots: int           # slot cap at the top level
    minpix: torch.Tensor     # [B, T_top, S] int32 min pixel id per slot


def bf16_round(x: torch.Tensor) -> torch.Tensor:
    """Round f32 to the nearest bf16 value (ties to even), kept as f32."""
    return x.to(torch.bfloat16).to(torch.float32)


def _to_tiles(img: torch.Tensor, s: int) -> torch.Tensor:
    """[B, H, W] -> [B * T, s * s], tiles row-major within each image."""
    b, height, width = img.shape
    return (img.reshape(b, height // s, s, width // s, s)
            .permute(0, 1, 3, 2, 4).reshape(-1, s * s))


def _from_tiles(tiles: torch.Tensor, b: int, height: int, width: int,
                s: int) -> torch.Tensor:
    """[B * T, s * s] -> [B, H, W]."""
    return (tiles.reshape(b, height // s, width // s, s, s)
            .permute(0, 1, 3, 2, 4).reshape(b, height, width))


def _take(vec: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """vec[t, idx[t, i]]; an index outside [0, S) reads 0, as the
    reference's one-hot lookups do."""
    slots = vec.shape[-1]
    ok = (idx >= 0) & (idx < slots)
    got = torch.gather(vec, -1, idx.clamp(0, slots - 1).long())
    return torch.where(ok, got, torch.zeros_like(got))


def _one_hot(idx: torch.Tensor, slots: int) -> torch.Tensor:
    """f32 one-hot over the last dim; indices outside [0, slots) give a zero
    row."""
    cols = torch.arange(slots, device=idx.device)
    return (idx.unsqueeze(-1) == cols).to(torch.float32)


def first_argmax(sym: torch.Tensor, best: torch.Tensor) -> torch.Tensor:
    """First index of each row's maximum `best` of sym [T, S, S]."""
    slots = sym.shape[-1]
    cols = torch.arange(slots, device=sym.device)
    return torch.where(sym == best.unsqueeze(-1), cols, slots).amin(dim=-1)


def _hook(sym: torch.Tensor) -> torch.Tensor:
    """One round's slot map [T, S] from the pair matrices [T, S, S]: hook
    every slot with an attractive best partner, break 2-cycles toward the
    smaller id, then 3 pointer doublings."""
    t_count, slots = sym.shape[:2]
    ids = torch.arange(slots, device=sym.device).expand(t_count, slots)
    best = sym.amax(dim=-1)
    nxt = torch.where(best > 0.0, first_argmax(sym, best), ids)
    nn = _take(nxt, nxt)
    nxt = torch.where((nn == ids) & (ids < nxt), ids, nxt)
    for _ in range(3):
        nxt = _take(nxt, nxt)
    return nxt


def _remap(sym: torch.Tensor, m: torch.Tensor, tgt: torch.Tensor,
           sentinel: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Aggregate the pair matrix and min-pixel vector through the slot map
    tgt [T, S] (-1 drops a slot): sym'[A, B] = sum over a -> A, b -> B of
    sym[a, b]; m'[A] = min over a -> A of m[a], the sentinel if none."""
    slots = m.shape[-1]
    mm = _one_hot(tgt, slots)                       # [T, S, S]
    sym = torch.bmm(mm.transpose(1, 2), torch.bmm(sym, mm))
    keep = tgt >= 0
    m_new = torch.full_like(m, sentinel).scatter_reduce(
        1, tgt.clamp(min=0), torch.where(keep, m, sentinel), "amin")
    return sym, m_new


def _matrix_rounds(sym: torch.Tensor, m: torch.Tensor, rounds: int,
                   sentinel: int):
    """GAEC rounds in slot space, then dense re-ranking.

    sym [T, S, S] f32, m [T, S] int32 (T = batch * tiles per image).
    Returns (sym, m, cmap, n_alive): cmap [T, S] int64 maps entry ranks to
    final dense ranks (entries of slots that were dead on entry are unused),
    n_alive [T] int64."""
    t_count, slots = m.shape
    ids = torch.arange(slots, device=m.device).expand(t_count, slots)
    off_diag = 1.0 - torch.eye(slots, device=m.device)
    cmap = ids
    for _ in range(rounds):
        nxt = _hook(sym)
        sym, m = _remap(sym, m, nxt, sentinel)
        sym = sym * off_diag
        cmap = _take(nxt, cmap)

    alive = m < sentinel
    new_rank = torch.cumsum(alive.long(), dim=1) - 1
    n_alive = alive.sum(dim=1)
    sym, m = _remap(sym, m, torch.where(alive, new_rank, -1), sentinel)
    cmap = _take(new_rank, cmap)
    return sym, m, cmap, n_alive


def _embed_children(p4: torch.Tensor, m4: torch.Tensor, off4: torch.Tensor,
                    slots: int, sentinel: int):
    """Embed four child pair matrices p4 [T, 4, Sp, Sp] and min-pixel
    vectors m4 [T, 4, Sp] at rank offsets off4 [T, 4] into [T, S, S] / [T, S];
    candidates >= S (frozen) drop out."""
    t_count, _, prev, _ = p4.shape
    cand = torch.arange(prev, device=p4.device) + off4.unsqueeze(-1)
    emb = _one_hot(cand, slots)                            # [T, 4, Sp, S]
    x = torch.matmul(p4, emb)                              # [T, 4, Sp, S]
    emb_f = emb.reshape(t_count, 4 * prev, slots)
    sym = torch.bmm(emb_f.transpose(1, 2), x.reshape(t_count, 4 * prev,
                                                     slots))
    keep = (cand < slots).reshape(t_count, -1)
    m = torch.full((t_count, slots), sentinel, dtype=m4.dtype,
                   device=p4.device)
    m = m.scatter_reduce(1, cand.reshape(t_count, -1).clamp(max=slots - 1),
                         torch.where(keep, m4.reshape(t_count, -1), sentinel),
                         "amin")
    return sym, m


def _pair_matrix(a_e: torch.Tensor, b_e: torch.Tensor, w_e: torch.Tensor,
                 slots: int) -> torch.Tensor:
    """Pair matrix [T, S, S] of an edge list: the f32 sum of the weights
    w_e [T, E] of the edges whose endpoint ranks are (a_e, b_e); endpoints
    outside [0, S) (frozen, -1) contribute nothing."""
    oh_aw = _one_hot(a_e, slots) * w_e.unsqueeze(-1)
    return torch.bmm(oh_aw.transpose(1, 2), _one_hot(b_e, slots))


def _edge_pairs(a_e: torch.Tensor, b_e: torch.Tensor, w_e: torch.Tensor,
                slots: int) -> torch.Tensor:
    """`_pair_matrix` of the bf16-rounded weights (the hierarchy's bf16
    operands with f32 accumulation; the products are exact in f32)."""
    return _pair_matrix(a_e, b_e, bf16_round(w_e), slots)


def _child_offsets(ncand: torch.Tensor, b: int, height: int, width: int,
                   prev_s: int, s: int):
    """Level transition offsets: each child tile's ranks shift by the live
    regions of the children before it (quad order 00, 01, 10, 11). Returns
    (off4 [B * T', 4], off_img [B, H, W], live regions per new tile
    [B, th, tw])."""
    th_p, tw_p = height // prev_s, width // prev_s
    th_n, tw_n = height // s, width // s
    counts = ncand.reshape(b, th_p, tw_p)
    c00 = counts[:, 0::2, 0::2]
    c01 = counts[:, 0::2, 1::2]
    c10 = counts[:, 1::2, 0::2]
    c11 = counts[:, 1::2, 1::2]
    off4 = torch.stack([torch.zeros_like(c00), c00, c00 + c01,
                        c00 + c01 + c10], dim=-1)        # [B, th, tw, 4]
    off_prev = (off4.reshape(b, th_n, tw_n, 2, 2).permute(0, 1, 3, 2, 4)
                .reshape(b, th_p, tw_p))
    off_img = (off_prev.repeat_interleave(prev_s, dim=1)
               .repeat_interleave(prev_s, dim=2))
    return off4.reshape(-1, 4), off_img, c00 + c01 + c10 + c11


def _matrix_transition(rank_img, ncand, sym, m, frozen, final_gid, overflow,
                       costs, prev_s: int, prev_slots: int, s: int,
                       slots: int):
    """Level transition in slot space: offset child ranks, freeze overflow
    (labels straight from m), embed the four child pair matrices, add the
    newly active mid-line edges."""
    b, height, width = rank_img.shape
    th_n, tw_n = height // s, width // s
    off4, off_img, live = _child_offsets(ncand, b, height, width, prev_s, s)
    cand_img = rank_img + off_img
    newly = ~frozen & (rank_img >= 0) & (cand_img >= slots)
    ranks_pt = _to_tiles(rank_img, prev_s)
    minpix = _from_tiles(_take(m, ranks_pt.clamp(min=0)), b, height, width,
                         prev_s).to(torch.int32)
    final_gid = torch.where(newly, minpix, final_gid)
    frozen = frozen | newly
    rank_img = torch.where(frozen, -1, cand_img)
    overflow = overflow + (live - slots).clamp(min=0).sum(
        dim=(1, 2)).to(torch.int32)

    p4 = (sym.reshape(b, th_n, 2, tw_n, 2, prev_slots, prev_slots)
          .permute(0, 1, 3, 2, 4, 5, 6).reshape(-1, 4, prev_slots, prev_slots))
    m4 = (m.reshape(b, th_n, 2, tw_n, 2, prev_slots)
          .permute(0, 1, 3, 2, 4, 5).reshape(-1, 4, prev_slots))
    sym_new, m_new = _embed_children(p4, m4, off4, slots, height * width)

    # newly active edges: the two mid-lines of each new tile
    half = s // 2

    def tiles_h(img):  # [B, H, tw] -> [B * T', s]
        return img.reshape(b, th_n, s, tw_n).permute(0, 1, 3, 2).reshape(-1, s)

    def tiles_v(img):  # [B, th, W] -> [B * T', s]
        return img.reshape(-1, s)

    a_e = torch.cat([tiles_h(rank_img[:, :, half - 1::s]),
                     tiles_v(rank_img[:, half - 1::s, :])], dim=1)
    b_e = torch.cat([tiles_h(rank_img[:, :, half::s]),
                     tiles_v(rank_img[:, half::s, :])], dim=1)
    w_e = torch.cat([tiles_h(costs[:, :, half - 1::s, 0]),
                     tiles_v(costs[:, half - 1::s, :, 1])], dim=1)
    pair = _edge_pairs(a_e, b_e, w_e, slots)
    sym_new = sym_new + pair + pair.transpose(1, 2)
    return rank_img, sym_new, m_new, frozen, final_gid, overflow


def _apply_slot_map(rank_img: torch.Tensor, cmap: torch.Tensor,
                    s: int) -> torch.Tensor:
    """Remap pixel ranks through a slot map (frozen stay frozen)."""
    b, height, width = rank_img.shape
    ranks_t = _to_tiles(rank_img, s)
    new_t = torch.where(ranks_t < 0, -1, _take(cmap, ranks_t))
    return _from_tiles(new_t, b, height, width, s)


def leaf_applies(sides: Sequence[int], caps: Sequence[int]) -> bool:
    """Whether levels 0-1 fit the multicut leaf: base 8, 64 level-0 slots,
    at least two levels and a level-1 cap the kernel holds."""
    return (len(sides) >= 2 and sides[0] == 8 and int(caps[0]) == 64
            and int(caps[1]) <= LEAF_MAX_S1)


def plan_levels(height: int, width: int, base: int = 8) -> list[int]:
    """Supertile sides: base, 2*base, ... while they divide both dims. Empty
    if base does not divide the image."""
    if height % base or width % base or height < base or width < base:
        return []
    sides = []
    s = base
    while height % s == 0 and width % s == 0 and s <= min(height, width):
        sides.append(s)
        s *= 2
    return sides


def default_caps(sides: Sequence[int]) -> list[int]:
    """Slot caps per level: the first level exact (s^2 singleton slots), then
    min(4 * previous, s^2, 64 + 64 * level)."""
    caps = []
    for i, s in enumerate(sides):
        if i == 0:
            caps.append(s * s)
        else:
            caps.append(int(min(4 * caps[-1], s * s, 64 + 64 * i)))
    return caps


def flat64_caps(sides: Sequence[int]) -> list[int]:
    """The "flat64" slot caps: `default_caps` with every level above the
    first capped at 64."""
    return [c if i == 0 else min(c, 64)
            for i, c in enumerate(default_caps(sides))]


def hier_gaec(costs_bhw2: torch.Tensor, rounds_per_level: Sequence[int],
              caps: Sequence[int]) -> HierResult:
    """The hierarchy over all levels of a batch of cost planes [B, H, W, 2]
    whose top supertile covers the image, levels 0-1 in the multicut leaf
    (reference/multicut_leaf.py); deeper levels repeat the last entry of
    `rounds_per_level`."""
    from portbench.reference.multicut_leaf import leaf_levels_fused
    b, height, width, _ = costs_bhw2.shape
    sides = plan_levels(height, width, 8)
    if not leaf_applies(sides, caps) or sides[-1] != height \
            or height != width:
        raise ValueError(f"the reference solves square images whose "
                         f"supertiles double from 8 to the side, levels 0-1 "
                         f"in the leaf; got {height}x{width}, caps "
                         f"{list(caps)[:2]}")
    rounds = (list(rounds_per_level) + [rounds_per_level[-1]]
              * (len(sides) - len(rounds_per_level)))
    costs = costs_bhw2.to(torch.float32)
    sentinel = height * width
    (rank_img, ncand, frozen, final_gid, overflow, sym,
     m) = leaf_levels_fused(costs, int(caps[1]), int(rounds[0]),
                            int(rounds[1]))
    for i in range(2, len(sides)):
        s, slots = sides[i], int(caps[i])
        rank_img, sym, m, frozen, final_gid, overflow = _matrix_transition(
            rank_img, ncand, sym, m, frozen, final_gid, overflow, costs,
            sides[i - 1], int(caps[i - 1]), s, slots)
        sym, m, cmap, ncand = _matrix_rounds(sym, m, int(rounds[i]),
                                             sentinel)
        rank_img = _apply_slot_map(rank_img, cmap, s)
    slots = int(caps[-1])
    return HierResult(rank_img.to(torch.int32),
                      ncand.reshape(b, -1).to(torch.int32), frozen,
                      final_gid.to(torch.int32), overflow.to(torch.int32),
                      sides[-1], slots,
                      minpix=m.reshape(b, -1, slots).to(torch.int32))


def smallest_pixel_labels(res: HierResult) -> torch.Tensor:
    """Relabel top-tile ranks to each region's smallest pixel index (the
    public label contract): one slot lookup into minpix; frozen regions
    carry theirs in final_gid. Returns [B, H, W] int32."""
    b, height, width = res.rank_img.shape
    s, slots = res.top_tile, res.top_slots
    ranks_t = _to_tiles(res.rank_img, s)
    lab_t = _take(res.minpix.reshape(-1, slots),
                  ranks_t.clamp(min=0)).to(torch.int32)
    labels = _from_tiles(lab_t, b, height, width, s)
    return torch.where(res.frozen, res.final_gid, labels)
