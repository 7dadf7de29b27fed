"""Configuration of the compress path.

The port's own copy of the fields of the reference's `config.py` that
compress reads (the reference's Config, MulticutConfig and the reward fields
used by the fallback decision and merge refinement). Defaults are the
reference's shipped defaults, except `MulticutConfig.hier_agg` (see there).
Every solver value the reference accepts is accepted; unknown values raise
where they are read (ops/multicut.multicut_grid).
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
from typing import Any


@dataclasses.dataclass
class RewardConfig:
    """Size-model fields read by the fallback decision and merge refinement
    (the reference's RewardConfig; see its comments for the calibration
    history behind each product default)."""

    overhead_base: float = 68.0      # real PNG container floor per slice
    entropy_correction: str = "miller_madow"
    literal_hist: str = "nonmatch"
    distance_window: int = 32768     # zlib window for the LZ distance term
    max_segments: int = 64           # static segment-slot cap per image


@dataclasses.dataclass
class MulticutConfig:
    """Grid multicut settings (the reference's MulticutConfig).

    `hier_agg` defaults to "matrix" where the reference ships "pixel": the
    slot-space aggregation makes the same merges (bit-identical labels on
    integer-valued costs) and is the configuration whose levels 0-1 run in
    the multicut leaf kernel; "pixel" re-aggregates pair costs from
    pixel-space one-hot products every round and never reaches the kernel.
    The reference's compress ignores `matchings_per_round` (its
    segment_batch keeps the solver default 4); the port passes it on."""

    max_rounds: int = 3               # sorted rounds (fixpoint bound)
    mode: str = "chain"               # chain | mutual | random_mate | hybrid
    icm_sweeps: int = 0               # local-move sweeps after contraction
    matchings_per_round: int = 4      # matching passes per sorted round
    hier_rounds: tuple = (2, 1)       # rounds per level (last repeats)
    hier_caps: str | None = "flat64"  # lean_caps preset | None = default caps
    hier_agg: str = "matrix"          # "matrix" slot-space | "pixel"
    hier_leaf: str = "auto"           # matrix agg: "auto"/"fused" run levels
    #                                   0-1 in the leaf kernel; "xla" (or
    #                                   "unfused") the level-by-level loop


@dataclasses.dataclass
class Config:
    """Top-level configuration of compress."""

    dataset_dir: str = "dataset/CLS-LOC/train"
    results_dir: str = "./results"
    image_format: str = "png"
    compression_level: int = 4       # zlib level of the slice PNGs
    compress_fallback: bool = True   # per-image single-slice fallback
    fallback_margin: float = 1.0     # keep iff est_sliced < margin * whole
    merge_refine_rounds: int = 2     # estimator-guided merges after fallback

    reward: RewardConfig = dataclasses.field(default_factory=RewardConfig)
    multicut: MulticutConfig = dataclasses.field(
        default_factory=MulticutConfig)

    @staticmethod
    def from_json(path: str | pathlib.Path) -> "Config":
        with open(path) as f:
            return Config.from_dict(json.load(f))

    @staticmethod
    def from_dict(raw: dict[str, Any]) -> "Config":
        cfg = Config()
        for key, value in raw.items():
            if not hasattr(cfg, key):
                raise KeyError(f"Unknown config key: {key}")
            current = getattr(cfg, key)
            if dataclasses.is_dataclass(current) and isinstance(value, dict):
                setattr(cfg, key, dataclasses.replace(current, **value))
            else:
                setattr(cfg, key, value)
        return cfg
