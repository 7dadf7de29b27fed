"""Estimator-guided region-merge refinement.

Port of the reference's ops/merge_refine.py, batched over images. Per
round: segment stats and per-slot size estimates; region adjacency with
shared-boundary lengths; greedy conflict-free matchings over the longest
boundaries (two per round, their pairs excluded from the next); ONE
estimator call over all matched unions of a matching (a pair-slot inverse);
then merges accepted greedily by predicted saving, conflict-free, when the
union prices below its parts and its bbox stays compact. A merged region
keeps the smaller label, so the minlabel contract survives. Same keep and
merge decisions as the reference.
"""

from __future__ import annotations

import torch

from image_compression_torch.ops.png_estimator import (
    class_sizes_for, estimate_segment_png_sizes_fast)
from image_compression_torch.ops.rewards import to_rgba_u8
from image_compression_torch.ops.segment_stats import segment_stats
from image_compression_torch.utils.profiling import (count, count_device,
                                                     span, tracing)


def _pair_counts(left: torch.Tensor, right: torch.Tensor,
                 k_max: int) -> torch.Tensor:
    """[B, k, k] counts of pixel pairs with slots (left, right)."""
    b = left.shape[0]
    idx = (left.reshape(b, -1) * k_max + right.reshape(b, -1)
           + torch.arange(b, device=left.device)[:, None] * k_max * k_max)
    return torch.bincount(idx.reshape(-1), minlength=b * k_max * k_max).to(
        torch.float32).reshape(b, k_max, k_max)


def _boundary_matrix(inverse: torch.Tensor, k_max: int) -> torch.Tensor:
    """[B, k, k] f32 shared boundary length: the number of 4-neighbour pixel
    pairs whose pixels lie in slots (a, b), a != b; symmetric."""
    inverse = inverse.to(torch.int64)
    bh = _pair_counts(inverse[:, :, :-1], inverse[:, :, 1:], k_max)
    bv = _pair_counts(inverse[:, :-1, :], inverse[:, 1:, :], k_max)
    mat = bh + bh.transpose(1, 2) + bv + bv.transpose(1, 2)
    return mat * (1.0 - torch.eye(k_max, device=inverse.device))


def _greedy_disjoint(values: torch.Tensor, pa: torch.Tensor, pb: torch.Tensor,
                     k_max: int) -> torch.Tensor:
    """Walk candidate pairs in order and accept one iff its value is
    positive and neither slot is taken yet. [B, n] -> accepted [B, n]."""
    b, n = values.shape
    used = torch.zeros((b, k_max), dtype=torch.bool, device=values.device)
    accept = torch.zeros((b, n), dtype=torch.bool, device=values.device)
    with span("merge.greedy", values.device):
        for i in range(n):
            a, c = pa[:, i:i + 1], pb[:, i:i + 1]
            ok = ((values[:, i:i + 1] > 0) & ~used.gather(1, a)
                  & ~used.gather(1, c))
            used.scatter_(1, a, used.gather(1, a) | ok)
            used.scatter_(1, c, used.gather(1, c) | ok)
            accept[:, i:i + 1] = ok
    return accept


def _sort_desc(values: torch.Tensor):
    """Descending order, lower index first among equal values (the
    reference's top_k order)."""
    return torch.sort(values, dim=1, descending=True, stable=True)


def _match_pairs(scores: torch.Tensor, k_max: int, max_pairs: int):
    """Greedy conflict-free matching over the `max_pairs` longest boundaries.
    Returns (pair_a, pair_b, accepted), each [B, max_pairs], a < b."""
    upper = torch.triu(torch.ones((k_max, k_max), dtype=torch.bool,
                                  device=scores.device), diagonal=1)
    flat = torch.where(upper, scores, 0.0).reshape(scores.shape[0], -1)
    top, idx = _sort_desc(flat)
    top, idx = top[:, :max_pairs], idx[:, :max_pairs]
    pa, pb = idx // k_max, idx % k_max
    return pa, pb, _greedy_disjoint(top, pa, pb, k_max)


def _bbox_area(bb: torch.Tensor) -> torch.Tensor:
    return ((bb[..., 2] - bb[..., 0] + 1)
            * (bb[..., 3] - bb[..., 1] + 1)).to(torch.float32)


def _merge_round(img_rgba: torch.Tensor, labels: torch.Tensor, *, k_max: int,
                 max_pairs: int, est_kwargs: dict,
                 matchings: int = 2) -> torch.Tensor:
    b, height, width = labels.shape
    dev = labels.device
    stats = segment_stats(labels, k_max)
    inverse = stats.inverse.to(torch.int64)
    est = estimate_segment_png_sizes_fast(
        img_rgba, inverse, stats.counts, stats.bboxes, stats.valid,
        **est_kwargs)

    scores = _boundary_matrix(inverse, k_max)
    # never merge the clamp bucket of an overflowed image, nor empty slots
    ks = torch.arange(k_max, device=dev)
    ok_slot = stats.valid & ~((ks == k_max - 1) & stats.overflow[:, None])
    scores = scores * ok_slot[:, :, None] * ok_slot[:, None, :]

    # union evaluations get real capacity in every crop class
    n_classes = len(class_sizes_for(height, width))
    caps = tuple([max_pairs] * (n_classes - 1) + [max(4, max_pairs // 4)])
    bb = stats.bboxes.to(torch.int64)
    pair_ids = torch.arange(max_pairs, device=dev).expand(b, max_pairs)
    cand_a, cand_b, cand_save = [], [], []
    for _ in range(matchings):
        pa, pb, accept = _match_pairs(scores, k_max, max_pairs)
        bba = torch.gather(bb, 1, pa[..., None].expand(-1, -1, 4))
        bbb = torch.gather(bb, 1, pb[..., None].expand(-1, -1, 4))
        bbox_u = torch.cat([torch.minimum(bba[..., :2], bbb[..., :2]),
                            torch.maximum(bba[..., 2:], bbb[..., 2:])], -1)
        counts_u = stats.counts.gather(1, pa) + stats.counts.gather(1, pb)
        # pair-slot inverse: pixels of an accepted pair's slots -> the pair
        # index, all others -> max_pairs (no slot); accepted pairs are
        # disjoint, the extra column takes the rejected ones
        pair_of_slot = torch.full((b, k_max + 1), max_pairs, device=dev)
        pair_of_slot.scatter_(1, torch.where(accept, pa, k_max), pair_ids)
        pair_of_slot.scatter_(1, torch.where(accept, pb, k_max), pair_ids)
        inv_pairs = torch.gather(pair_of_slot[:, :k_max], 1,
                                 inverse.reshape(b, -1)).reshape(b, height,
                                                                 width)
        est_u = estimate_segment_png_sizes_fast(
            img_rgba, inv_pairs, counts_u, bbox_u, accept, class_caps=caps,
            **est_kwargs)
        # compactness guard: a union whose bbox blows up relative to the
        # parts is mostly transparent canvas
        compact = _bbox_area(bbox_u) <= 1.5 * (_bbox_area(bba)
                                               + _bbox_area(bbb))
        cand_a.append(pa)
        cand_b.append(pb)
        cand_save.append(torch.where(
            accept & compact, est.gather(1, pa) + est.gather(1, pb) - est_u,
            -torch.inf))
        # this matching's pairs leave the next matching's scores
        hit = torch.zeros((b, k_max * k_max + 1), dtype=torch.bool,
                          device=dev)
        hit.scatter_(1, torch.where(accept, pa * k_max + pb, k_max * k_max),
                     True)
        hit.scatter_(1, torch.where(accept, pb * k_max + pa, k_max * k_max),
                     True)
        scores = torch.where(hit[:, :-1].reshape(b, k_max, k_max), 0.0,
                             scores)

    pa = torch.cat(cand_a, dim=1)
    pb = torch.cat(cand_b, dim=1)
    order_save, order = _sort_desc(torch.cat(cand_save, dim=1))
    pa_o, pb_o = pa.gather(1, order), pb.gather(1, order)
    do_merge = _greedy_disjoint(order_save, pa_o, pb_o, k_max)
    if tracing():
        count_device("merge.pairs", do_merge.sum())

    # apply: pixels of slot b take slot a's label (the smaller one: slot ids
    # ascend with label values)
    big = 2 ** 30
    flat_lab = labels.reshape(b, -1).to(torch.int64)
    slot_min = torch.full((b, k_max), big, dtype=torch.int64,
                          device=dev).scatter_reduce(
        1, inverse.reshape(b, -1), flat_lab, "amin")
    tgt = torch.where(do_merge, pb_o, k_max)
    merged = torch.zeros((b, k_max + 1), dtype=torch.bool, device=dev)
    merged.scatter_(1, tgt, True)
    new_lab = torch.zeros((b, k_max + 1), dtype=torch.int64, device=dev)
    new_lab.scatter_(1, tgt, slot_min.gather(1, pa_o))
    inv_flat = inverse.reshape(b, -1)
    out = torch.where(merged[:, :k_max].gather(1, inv_flat),
                      new_lab[:, :k_max].gather(1, inv_flat), flat_lab)
    return out.reshape(b, height, width).to(labels.dtype)


def merge_refine_batch(images_f01: torch.Tensor, labels_bhw: torch.Tensor, *,
                       k_max: int = 64, rounds: int = 2, max_pairs: int = 32,
                       min_pixels: int = 1, l_min: int = 4,
                       beta: float = 0.012167, b_match_token: float = 18.0,
                       gamma: float = 0.1, overhead_base: float = 68.0,
                       adaptive_filter: bool = True,
                       entropy_correction: str = "miller_madow",
                       literal_hist: str = "nonmatch",
                       distance_window: int = 32768) -> torch.Tensor:
    """Batched merge refinement: images [B, H, W, 3] f01, labels [B, H, W]
    int. Returns refined labels (same dtype); minlabel inputs stay
    minlabel.

    An image that enters with one region (a declined image) has nothing to
    merge: its round is the identity (no boundary, so no pair is accepted).
    Merging is per image, so only the images with more than one region run
    the rounds, as a sub-batch written back into a copy of the labels; a
    batch of one-region images comes back as it is. Deciding costs one
    sync. Traced, the images passed over are counted as
    "merge.noop_images", and the pairs each round merges as "merge.pairs"
    (on the device, no sync)."""
    b = labels_bhw.shape[0]
    flat = labels_bhw.flatten(1)
    multi = (flat != flat[:, :1]).any(dim=1)
    n_multi = int(multi.sum())
    if tracing():
        count("merge.noop_images", b - n_multi)
    if n_multi == 0:
        return labels_bhw
    est_kwargs = dict(min_pixels=min_pixels, l_min=l_min, beta=beta,
                      b_match_token=b_match_token, gamma=gamma,
                      overhead_base=overhead_base,
                      adaptive_filter=adaptive_filter,
                      entropy_correction=entropy_correction,
                      literal_hist=literal_hist,
                      distance_window=distance_window)
    images, labels = images_f01, labels_bhw
    if n_multi < b:
        # the multi-region images' indices, ascending (a sort, where
        # nonzero would sync again)
        idx = torch.sort(multi.to(torch.uint8), descending=True,
                         stable=True).indices[:n_multi]
        images = images_f01.index_select(0, idx)
        labels = labels_bhw.index_select(0, idx)
    imgs = to_rgba_u8(images)
    for _ in range(rounds):
        labels = _merge_round(imgs, labels, k_max=k_max,
                              max_pairs=max_pairs, est_kwargs=est_kwargs)
    if n_multi < b:
        labels = labels_bhw.index_copy(0, idx, labels)
    return labels
