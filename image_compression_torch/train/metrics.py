"""Edge classification metrics and the JSONL metrics log.

Port of the reference's train/metrics.py: predict connect iff
sigmoid(logit) >= thresh, confusion counts restricted to valid-mask
entries, precision/recall/F1 for the connect-positive and cut-positive
views; and `MetricsLogger`, one JSON object per line in
results_dir/metrics_<run_id>.jsonl, flushed per record.
"""

from __future__ import annotations

import json
import math
import pathlib
import time
from typing import NamedTuple

import torch


class EdgeMetrics(NamedTuple):
    tp_conn: torch.Tensor
    fp_conn: torch.Tensor
    fn_conn: torch.Tensor
    tn_conn: torch.Tensor
    tp_cut: torch.Tensor
    fp_cut: torch.Tensor
    fn_cut: torch.Tensor
    tn_cut: torch.Tensor

    def summary(self) -> dict[str, float]:
        eps = 1e-12
        tp_c, fp_c, fn_c = (float(self.tp_conn), float(self.fp_conn),
                            float(self.fn_conn))
        tp_k, fp_k, fn_k = (float(self.tp_cut), float(self.fp_cut),
                            float(self.fn_cut))
        p_c = tp_c / (tp_c + fp_c + eps)
        r_c = tp_c / (tp_c + fn_c + eps)
        p_k = tp_k / (tp_k + fp_k + eps)
        r_k = tp_k / (tp_k + fn_k + eps)
        return {
            "precision_conn": p_c, "recall_conn": r_c,
            "f1_conn": 2 * p_c * r_c / (p_c + r_c + eps),
            "precision_cut": p_k, "recall_cut": r_k,
            "f1_cut": 2 * p_k * r_k / (p_k + r_k + eps),
        }

    def __add__(self, other: "EdgeMetrics") -> "EdgeMetrics":
        return EdgeMetrics(*[a + b for a, b in zip(self, other)])


def edge_metrics(outputs: torch.Tensor, targets: torch.Tensor,
                 thresh: float = 0.5) -> EdgeMetrics:
    """outputs [B, H, W, 4] (logit_r, _, logit_d, _); targets [B, H, W, 4].
    Counts are int64 scalars."""
    logit_thresh = math.log(thresh / (1.0 - thresh))

    def counts(logits, y, mask):
        pred_conn = logits >= logit_thresh
        gt_conn = y >= 0.5
        m = mask > 0.5
        return ((pred_conn & gt_conn & m).sum(),
                (pred_conn & ~gt_conn & m).sum(),
                (~pred_conn & gt_conn & m).sum(),
                (~pred_conn & ~gt_conn & m).sum())

    tp_r, fp_r, fn_r, tn_r = counts(outputs[..., 0], targets[..., 0],
                                    targets[..., 2])
    tp_d, fp_d, fn_d, tn_d = counts(outputs[..., 2], targets[..., 1],
                                    targets[..., 3])
    tp_conn, fp_conn = tp_r + tp_d, fp_r + fp_d
    fn_conn, tn_conn = fn_r + fn_d, tn_r + tn_d
    # cut as the positive class swaps TP<->TN and FP<->FN
    return EdgeMetrics(tp_conn, fp_conn, fn_conn, tn_conn,
                       tn_conn, fn_conn, fp_conn, tp_conn)


class MetricsLogger:
    """Structured JSONL metrics sink: one JSON object per line in
    results_dir/metrics_<run_id>.jsonl, each with a leading "time" key,
    flushed per record so that readers and crashed runs see everything
    written so far."""

    def __init__(self, results_dir, run_id: str):
        d = pathlib.Path(results_dir)
        d.mkdir(parents=True, exist_ok=True)
        self.path = d / f"metrics_{run_id}.jsonl"
        self._fh = open(self.path, "a")

    def write(self, record: dict) -> None:
        record = {"time": round(time.time(), 3), **record}
        self._fh.write(json.dumps(record) + "\n")
        self._fh.flush()

    def close(self) -> None:
        self._fh.close()
