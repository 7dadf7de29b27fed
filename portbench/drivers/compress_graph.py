"""Checkpoint-free compress cells: the compress driver's closed loop
(drivers/compress.py: its window, jobs, profile and context) over
`compress_directory` with the Felzenszwalb-Huttenlocher graph extractor's
costs (`classical=EdgeTarget.GRAPH`) in the U-Net's place, as
`compress --classical graph` runs it.

Set-up writes the corpus from the seed and warms up on one whole job; there
are no weights. The checked job keeps each batch the extractor saw (the
pipeline's `classical_costs_signed` wrapped) and the solver's labels with
the cost planes they were solved from (`segment_batch` wrapped), and the
check holds them and the job's output against reference/compress_graph.py.
"""

from __future__ import annotations

import pathlib
import shutil

import torch

from portbench import trace
from portbench.drivers import compress
from portbench.traffic import generator


class Run(compress.Run):
    def setup(self) -> None:
        from image_compression_torch import pipeline
        from image_compression_torch.config import Config, EdgeTarget
        self.pipeline = pipeline
        self.classical = EdgeTarget.GRAPH
        corpus_dir = self.workdir / "corpus"
        self.corpus = generator.make(self.traffic, self.seed, corpus_dir)
        self.cfg = Config.from_dict(self.config["settings"])
        self.cfg.dataset_dir = str(corpus_dir)
        self._job(corpus_dir, self.workdir / "warm_out")
        shutil.rmtree(self.workdir / "warm_out")

    def _job(self, dataset: pathlib.Path, out: pathlib.Path,
             timings: dict | None = None) -> list[pathlib.Path]:
        self.cfg.dataset_dir = str(dataset)
        self.cfg.results_dir = str(out)
        return self.pipeline.compress_directory(
            self.cfg, classical=self.classical, batch_size=self.batch_size,
            device=self.device, timings=timings)

    def _kept_job(self, dataset: pathlib.Path, out: pathlib.Path,
                  timings: dict | None = None) -> list[pathlib.Path]:
        """A job that keeps what the check compares: each batch the
        extractor saw, and each batch's cost planes and labels from the
        solver."""
        pipe = self.pipeline
        solve, costs = pipe.segment_batch, pipe.classical_costs_signed

        def kept_solve(c, *a, **k):
            labels = solve(c, *a, **k)
            self.solved.append((c.clone(), labels.clone()))
            return labels

        def kept_costs(images, target):
            self.captured.append(images.clone())
            return costs(images, target)

        pipe.segment_batch, pipe.classical_costs_signed = kept_solve, \
            kept_costs
        try:
            return self._job(dataset, out, timings)
        finally:
            pipe.segment_batch, pipe.classical_costs_signed = solve, costs

    def profile(self) -> dict | None:
        """compress.Run's traced job, the extractor in the "costs" range
        (the U-Net's stage there)."""
        pipe = self.pipeline
        costs = pipe.classical_costs_signed

        def ranged(*a, **k):
            with trace.stage("costs"):
                return costs(*a, **k)

        pipe.classical_costs_signed = ranged
        try:
            return super().profile()
        finally:
            pipe.classical_costs_signed = costs

    def check(self) -> dict:
        from portbench.reference import compress_graph as ref
        if self.device == "cuda":
            torch.cuda.empty_cache()
        return ref.check(self.spec, self.corpus,
                         self.workdir / f"out{self.check_job}",
                         self.captured, self.solved, self.device)
