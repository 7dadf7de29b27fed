"""Random rectangle (BSP) partitions as ground truth for slicing and
multicut tests.

The port's copy of the reference's utils/random_partition.py (numpy only):
`random_rect_partition` tiles an image with random rectangles and
`partition_to_edge_signs` gives the +-1 edge planes of a label map, the
multicut problem whose optimum is the partition.
"""

from __future__ import annotations

import numpy as np


def random_rect_partition(height: int, width: int, min_h: int = 8,
                          min_w: int = 8, split_prob: float = 0.75,
                          min_rect_count: int = 1,
                          seed: int = 0) -> np.ndarray:
    """Random BSP tiling -> label map [H, W] int32 (one id per rectangle).

    Same construction as random_partition.hpp:58-127: recursively split the
    image with probability split_prob (forced while below min_rect_count),
    orientation biased by aspect ratio, split point uniform respecting
    min_h/min_w.
    """
    rng = np.random.default_rng(seed)
    pending = [(0, 0, width, height)]  # (x0, y0, w, h)
    rects = []

    while pending:
        need_more = len(pending) + len(rects) < min_rect_count
        if need_more:
            splittable = [i for i, r in enumerate(pending)
                          if r[2] >= 2 * min_w or r[3] >= 2 * min_h]
            if not splittable:
                rects.extend(pending)
                break
            i = max(splittable, key=lambda i: pending[i][2] * pending[i][3])
            r = pending.pop(i)
        else:
            r = pending.pop()

        x0, y0, w, h = r
        can_v = w >= 2 * min_w
        can_h = h >= 2 * min_h
        split_now = (can_v or can_h) and (need_more or rng.random() < split_prob)
        if not split_now:
            rects.append(r)
            continue

        if can_v and can_h:
            split_v = rng.random() < w / (w + h)
        else:
            split_v = can_v
        if split_v:
            sx = int(rng.integers(x0 + min_w, x0 + w - min_w + 1))
            pending.append((x0, y0, sx - x0, h))
            pending.append((sx, y0, x0 + w - sx, h))
        else:
            sy = int(rng.integers(y0 + min_h, y0 + h - min_h + 1))
            pending.append((x0, y0, w, sy - y0))
            pending.append((x0, sy, w, y0 + h - sy))

    labels = np.empty((height, width), np.int32)
    for rid, (x0, y0, w, h) in enumerate(rects):
        labels[y0:y0 + h, x0:x0 + w] = rid
    return labels


def partition_to_edge_signs(labels: np.ndarray) -> np.ndarray:
    """Label map -> signed edge planes [H, W, 2] int8 (+1 same rect, -1 cut).

    Matches the +-1 edge-tensor output contract of random_partition.hpp:17-20
    (padding positions at the last column/row are +1 there; they are masked
    out by consumers either way).
    """
    h_same = labels[:, :-1] == labels[:, 1:]
    v_same = labels[:-1, :] == labels[1:, :]
    out = np.ones((2, *labels.shape), np.int8)
    out[0, :, :-1] = np.where(h_same, 1, -1)
    out[1, :-1, :] = np.where(v_same, 1, -1)
    return np.moveaxis(out, 0, -1)
