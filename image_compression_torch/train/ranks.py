"""What a training loop does on each rank of a data-parallel run.

Shared by train/pretrain.py and train/reinforce.py: whether the loop runs
data parallel (use_mesh inside a torch.distributed process group, see
parallel/), this rank's slice of every global batch and its device, rank
0's run id, and rank 0's checkpoints, metrics and log lines, nothing on the
other ranks.
"""

from __future__ import annotations

from image_compression_torch.device import resolve_device
from image_compression_torch.parallel import mesh as pmesh
from image_compression_torch.train.checkpoint import (CheckpointManager,
                                                      new_run_id)
from image_compression_torch.train.metrics import MetricsLogger


class RankSetup:
    """Data parallelism of a training loop: whether it runs (use_mesh and a
    process group), this rank, the world size and the device; rank 0's run
    id; rank 0's checkpoints, metrics and log lines, nothing elsewhere.

    use_mesh=False inside a process group raises: every rank would train
    the whole batch and write into the same results directory."""

    def __init__(self, use_mesh: bool, device, global_batch: int,
                 results_dir, phase: str, log):
        if not use_mesh and pmesh.distributed():
            raise ValueError(
                f"use_mesh=False inside a process group of "
                f"{pmesh.world()[1]} ranks: destroy the group or train "
                "data parallel")
        self.dp = pmesh.distributed()
        self.rank, self.size = pmesh.world()
        self.device = (pmesh.rank_device(device) if self.dp
                       else resolve_device(device))
        self.rows = (pmesh.rank_slice(global_batch) if self.dp
                     else slice(None))  # raises if the batch does not divide
        self.lead = self.rank == 0
        self.ckpt = CheckpointManager(
            results_dir, phase,
            pmesh.broadcast_object(new_run_id()) if self.dp else None)
        self.log = log if self.lead else (lambda *_: None)

    def save(self, tag: str, state):
        return self.ckpt.save(tag, state) if self.lead else None

    def metrics(self, results_dir):
        return (MetricsLogger(results_dir, self.ckpt.run_id) if self.lead
                else _NoMetrics())

    def shard(self, n: int) -> slice | None:
        """This rank's rows of a batch of n, or None (the whole batch on
        every rank) without data parallelism or when n does not divide."""
        if not self.dp or n % self.size:
            return None
        return pmesh.rank_slice(n)


class _NoMetrics:
    def write(self, record: dict) -> None:
        pass

    def close(self) -> None:
        pass
