"""Frozen copy of the port's `ops/segment_stats.py` (plain PyTorch), part of the
benchmark's reference; it imports nothing of the program.

Per-segment statistics: label compaction, pixel counts, bounding boxes.

Port of the reference's ops/segment_stats.py, batched: labels [B, H, W].
Compact ids ascend with the label values; up to k_max segments are tracked
per image and surplus segments are clamped into the last slot (`overflow`
reports it). Outputs are bit-identical to the reference's.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class SegmentStats(NamedTuple):
    inverse: torch.Tensor       # [B, H, W] int32 compact ids in [0, k_max)
    counts: torch.Tensor        # [B, k_max] int32 pixel counts
    bboxes: torch.Tensor        # [B, k_max, 4] int32 (x0, y0, x1, y1);
    #                             empty slots (W, H, -1, -1)
    valid: torch.Tensor         # [B, k_max] bool
    num_segments: torch.Tensor  # [B] int32 true K (may exceed k_max)
    overflow: torch.Tensor      # [B] bool: K > k_max


def _stats_from_inverse(inverse: torch.Tensor, num_segments: torch.Tensor,
                        k_max: int) -> SegmentStats:
    """Counts and bboxes of compact ids inverse [B, H, W] (int64)."""
    b, height, width = inverse.shape
    dev = inverse.device
    flat = inverse.reshape(b, -1)
    counts = torch.zeros((b, k_max), dtype=torch.int64, device=dev)
    counts.scatter_add_(1, flat, torch.ones_like(flat))
    xs = torch.arange(width, device=dev).repeat(height).expand(b, -1)
    ys = (torch.arange(height, device=dev).repeat_interleave(width)
          .expand(b, -1))

    def seg(vals, init, reduce):
        out = torch.full((b, k_max), init, dtype=torch.int64, device=dev)
        return out.scatter_reduce(1, flat, vals, reduce)

    x0 = seg(xs, width, "amin")
    y0 = seg(ys, height, "amin")
    x1 = seg(xs, -1, "amax")
    y1 = seg(ys, -1, "amax")
    valid = (torch.arange(k_max, device=dev)[None, :]
             < num_segments[:, None])
    x0 = torch.where(valid, x0, width)
    y0 = torch.where(valid, y0, height)
    x1 = torch.where(valid, x1, -1)
    y1 = torch.where(valid, y1, -1)
    return SegmentStats(inverse.to(torch.int32), counts.to(torch.int32),
                        torch.stack([x0, y0, x1, y1], dim=-1).to(torch.int32),
                        valid, num_segments.to(torch.int32),
                        num_segments > k_max)


def segment_stats(labels_bhw: torch.Tensor, k_max: int) -> SegmentStats:
    """Sorted compaction (at::_unique(sorted=true) semantics) of arbitrary
    integer labels."""
    b, height, width = labels_bhw.shape
    labels = labels_bhw.reshape(b, -1).to(torch.int64)
    lo = labels.amin(dim=1, keepdim=True)
    span = int((labels.amax() - labels.amin()).item()) + 1 if b else 1
    # one unique over the batch: image b's labels live in [b*span, (b+1)*span)
    image = torch.arange(b, device=labels.device)[:, None]
    keys = (labels - lo) + image * span
    uniq, inv = torch.unique(keys, sorted=True, return_inverse=True)
    per_image = torch.bincount(uniq // span, minlength=b)
    first = torch.cumsum(per_image, 0) - per_image
    rank = inv - first[:, None]
    inverse = rank.clamp(max=k_max - 1).reshape(b, height, width)
    return _stats_from_inverse(inverse, per_image, k_max)


def _representatives(labels: torch.Tensor, slots: int):
    """For minlabel labels [B, H, W] (int64): label of the rank-k region
    representative for k < slots (H*W past the last region) and the region
    count, by the reference's two-level counting."""
    b, height, width = labels.shape
    dev = labels.device
    n = height * width
    pix = torch.arange(n, device=dev).reshape(height, width)
    rep = (labels == pix).to(torch.int64)
    row_counts = rep.sum(dim=2)                                # [B, H]
    cum_rows = torch.cumsum(row_counts, dim=1)
    row_start = cum_rows - row_counts
    num_segments = cum_rows[:, -1]
    row_cum = torch.cumsum(rep, dim=2)                          # [B, H, W]
    ks = torch.arange(slots, device=dev)
    row_k = (cum_rows[:, :, None] <= ks).sum(dim=1)             # [B, slots]
    row_k_c = row_k.clamp(max=height - 1)
    sel = torch.gather(row_cum, 1,
                       row_k_c[:, :, None].expand(b, slots, width))
    tgt = ks - torch.gather(row_start, 1, row_k_c)
    x_k = (sel <= tgt[:, :, None]).sum(dim=2)
    label_of_slot = torch.where(ks < num_segments[:, None],
                                row_k * width + x_k, n)
    return label_of_slot, num_segments


def segment_stats_minlabel(labels_bhw: torch.Tensor,
                           k_max: int) -> SegmentStats:
    """Sort-free segment stats for labels satisfying the multicut output
    contract (label = smallest pixel index of its region): compact ids are
    ranks of the representatives (pixels whose index equals their label),
    located by two-level counting; the last slot also absorbs every label
    beyond it. Same outputs as the reference's function on any labels."""
    if k_max > 256:
        raise ValueError(f"segment_stats_minlabel requires k_max <= 256, "
                         f"got {k_max}")
    b, height, width = labels_bhw.shape
    labels = labels_bhw.to(torch.int64)
    label_of_slot, num_segments = _representatives(labels, k_max)
    ks = torch.arange(k_max, device=labels.device)
    lab = labels[..., None]
    oh = torch.where(ks == k_max - 1, lab >= label_of_slot[:, None, None, -1:],
                     lab == label_of_slot[:, None, None, :])   # [B, H, W, k]
    inverse = (oh.to(torch.int64) * ks).sum(dim=-1)
    col_cnt = oh.sum(dim=1)                                    # [B, W, k]
    row_cnt = oh.sum(dim=2)                                    # [B, H, k]
    counts = col_cnt.sum(dim=1)
    xs = torch.arange(width, device=labels.device)[None, :, None]
    ys = torch.arange(height, device=labels.device)[None, :, None]
    x0 = torch.where(col_cnt > 0, xs, width).amin(dim=1)
    x1 = torch.where(col_cnt > 0, xs, -1).amax(dim=1)
    y0 = torch.where(row_cnt > 0, ys, height).amin(dim=1)
    y1 = torch.where(row_cnt > 0, ys, -1).amax(dim=1)
    return SegmentStats(inverse.to(torch.int32), counts.to(torch.int32),
                        torch.stack([x0, y0, x1, y1], dim=-1).to(torch.int32),
                        ks[None, :] < num_segments[:, None],
                        num_segments.to(torch.int32), num_segments > k_max)
