"""Estimated total slice bytes per image (the size model's sum).

Port of the parts of the reference's ops/rewards.py that compress uses:
`to_rgba_u8` and `estimated_total_sizes_batched` (segment stats + the
size-bucketed estimator, batched over images).
"""

from __future__ import annotations

import torch

from image_compression_torch.ops.png_estimator import (
    estimate_segment_png_sizes_fast)
from image_compression_torch.ops.segment_stats import (segment_stats,
                                                       segment_stats_minlabel)


def to_rgba_u8(images_f01: torch.Tensor) -> torch.Tensor:
    """[..., H, W, 3] float [0, 1] -> [..., H, W, 4] uint8, alpha 255."""
    rgb = (images_f01 * 255.0).round().clamp(0, 255).to(torch.uint8)
    alpha = torch.full(rgb.shape[:-1] + (1,), 255, dtype=torch.uint8,
                       device=rgb.device)
    return torch.cat([rgb, alpha], dim=-1)


def estimated_total_sizes_batched(images_f01: torch.Tensor,
                                  labels_bhw: torch.Tensor, *,
                                  k_max: int = 64, min_pixels: int = 1,
                                  l_min: int = 4, beta: float = 0.012167,
                                  b_match_token: float = 18.0,
                                  gamma: float = 0.1,
                                  overhead_base: float = 9.308622,
                                  adaptive_filter: bool = True,
                                  minlabel: bool = False,
                                  entropy_correction: str = "none",
                                  literal_hist: str = "all",
                                  distance_window: int = 0) -> torch.Tensor:
    """Estimated total compressed bytes of all slices of each image [B].

    Segments beyond k_max share the last slot (estimated as one
    pseudo-segment); each surplus segment adds the lower bound of its
    container overhead plus one filter-byte row."""
    stats = (segment_stats_minlabel if minlabel else segment_stats)(
        labels_bhw, k_max)
    seg_sizes = estimate_segment_png_sizes_fast(
        to_rgba_u8(images_f01), stats.inverse, stats.counts, stats.bboxes,
        stats.valid, min_pixels=min_pixels, l_min=l_min, beta=beta,
        b_match_token=b_match_token, gamma=gamma,
        overhead_base=overhead_base, adaptive_filter=adaptive_filter,
        entropy_correction=entropy_correction, literal_hist=literal_hist,
        distance_window=distance_window)
    surplus = (stats.num_segments - k_max).clamp(min=0)
    return seg_sizes.sum(dim=1) + surplus * (overhead_base + 1.0)
