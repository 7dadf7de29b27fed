"""Batched compression reward: estimated slice sizes vs. the original file.

Port of the reference's ops/rewards.py: `to_rgba_u8`, the estimated total
slice bytes per image (segment stats + the PNG size estimator, batched over
images) and the REINFORCE reward built on it.

Reward per image:
    R = (size_image - sum_k est_size_k) / size_image
        - lambda * [exactly one segment with count >= min_pixels]
or, with fallback_aware, the graded advantage over the single-slice option
    R = max((est_whole - est_sliced) / size_image, -fallback_reward_clip).
"""

from __future__ import annotations

import torch

from image_compression_torch.ops.png_estimator import (
    estimate_segment_png_sizes, estimate_segment_png_sizes_fast)
from image_compression_torch.ops.segment_stats import (segment_stats,
                                                       segment_stats_minlabel)
from image_compression_torch.utils.profiling import span


def to_rgba_u8(images_f01: torch.Tensor) -> torch.Tensor:
    """[..., H, W, 3] float [0, 1] -> [..., H, W, 4] uint8, alpha 255."""
    rgb = (images_f01 * 255.0).round().clamp(0, 255).to(torch.uint8)
    alpha = torch.full(rgb.shape[:-1] + (1,), 255, dtype=torch.uint8,
                       device=rgb.device)
    return torch.cat([rgb, alpha], dim=-1)


def _total_est(imgs_rgba: torch.Tensor, labels_bhw: torch.Tensor, *,
               k_max: int, min_pixels: int, overhead_base: float, fast: bool,
               minlabel: bool, **est_kwargs):
    """The reference's `_total_est_one` over a batch: estimated total slice
    bytes [B] and the count of segments with >= min_pixels pixels [B].

    Segments beyond k_max share the last slot (estimated as one
    pseudo-segment); each surplus segment adds the lower bound of its
    container overhead plus one filter-byte row."""
    stats = (segment_stats_minlabel if minlabel else segment_stats)(
        labels_bhw, k_max)
    estimator = (estimate_segment_png_sizes_fast if fast
                 else estimate_segment_png_sizes)
    seg_sizes = estimator(imgs_rgba, stats.inverse, stats.counts,
                          stats.bboxes, stats.valid, min_pixels=min_pixels,
                          overhead_base=overhead_base, **est_kwargs)
    surplus = (stats.num_segments - k_max).clamp(min=0)
    total = seg_sizes.sum(dim=1) + surplus * (overhead_base + 1.0)
    k_valid = ((stats.counts >= min_pixels) & stats.valid).sum(dim=1)
    return total, k_valid


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
    """Estimated total compressed bytes of all slices of each image [B]."""
    return _total_est(
        to_rgba_u8(images_f01), labels_bhw, k_max=k_max,
        min_pixels=min_pixels, l_min=l_min, beta=beta,
        b_match_token=b_match_token, gamma=gamma,
        overhead_base=overhead_base, adaptive_filter=adaptive_filter,
        fast=True, minlabel=minlabel, entropy_correction=entropy_correction,
        literal_hist=literal_hist, distance_window=distance_window)[0]


def compute_rewards_batched(images_f01: torch.Tensor,
                            labels_bhw: torch.Tensor,
                            image_sizes_b: torch.Tensor, *, k_max: int = 64,
                            min_pixels: int = 1, l_min: int = 4,
                            beta: float = 0.012167,
                            b_match_token: float = 18.0, gamma: float = 0.1,
                            overhead_base: float = 9.308622,
                            adaptive_filter: bool = True, lam: float = 0.5,
                            fast: bool = True, minlabel: bool = False,
                            entropy_correction: str = "none",
                            literal_hist: str = "all",
                            fallback_aware: bool = False,
                            fallback_reward_clip: float = 0.25,
                            distance_window: int = 0) -> torch.Tensor:
    """images [B, H, W, 3] float [0, 1]; labels [B, H, W] int; sizes [B]
    (on-disk byte counts). Returns rewards [B] f32; the defaults are the
    reference function's.

    minlabel=True takes the sort-free segment stats; it needs labels that
    are each region's smallest pixel index, with connected regions
    (`produces_minlabel` says when the solver gives them).

    fallback_aware=True scores each image against the single-slice option
    compress would take instead: R = max((est_whole - est_sliced) / size,
    -fallback_reward_clip), without the single-segment penalty (the
    all-zeros labeling is its own minlabel form). Traced, a span
    "reward"."""
    kw = dict(k_max=k_max, min_pixels=min_pixels, l_min=l_min, beta=beta,
              b_match_token=b_match_token, gamma=gamma,
              overhead_base=overhead_base, adaptive_filter=adaptive_filter,
              fast=fast, minlabel=minlabel,
              entropy_correction=entropy_correction,
              literal_hist=literal_hist, distance_window=distance_window)
    with span("reward", images_f01.device):
        imgs = to_rgba_u8(images_f01)
        total_est, k_valid = _total_est(imgs, labels_bhw, **kw)
        size = image_sizes_b.to(device=imgs.device, dtype=torch.float32)
        if fallback_aware:
            est_whole, _ = _total_est(imgs, torch.zeros_like(labels_bhw),
                                      **kw)
            return torch.clamp((est_whole - total_est) / size,
                               min=-fallback_reward_clip)
        penalty = (k_valid == 1).to(torch.float32)
        return (size - total_est) / size - lam * penalty
