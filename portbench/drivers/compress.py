"""Compress cells: a closed loop of one client over the program's `compress`
entry point, `image_compression_torch.pipeline.compress_directory`.

Set-up writes the cell's corpus from the seed, loads the configuration's
weights file into the program's EdgeUNet and warms up on one whole job:
every batch the window runs (the corpus's partial batch too), the writer
over a whole job and the first reads of the corpus (the first run in a
checkout also builds the leaf kernel and the PNG writer there). A job is
one compress_directory call over the whole corpus directory into a fresh
results directory, at the configuration's batch size. The window's clock
runs around each call alone: its length is the summed seconds of its jobs,
it holds every job that started before that sum reached --seconds, and
`images_per_s` is the images completed over that sum. Between the timed
calls each job's seconds go to standard error and its output bytes are
measured, then deleted (at once: a job's pages deleted within seconds are
never written back to disk). One job, drawn from the seed among the
window's first two, keeps its output, the U-Net outputs the program
computed (a forward hook on the model) and the solver's labels before the
fallback with the cost planes they were solved from (`segment_batch`
wrapped), and the check holds them against the reference.
"""

from __future__ import annotations

import hashlib
import pathlib
import shutil
import sys
import time

import torch

from portbench import harness, trace
from portbench.cost import model as cost
from portbench.traffic import generator

STAGES = (("load_image", "load"), ("learned_costs", "costs"),
          ("segment_batch", "solver"), ("fallback_single_slice", "fallback"),
          ("merge_refine_batch", "merge"), ("_pack_wire", "wire"),
          ("_timed_write", "write"))


def weights_path(config: dict) -> pathlib.Path:
    """The configuration's weights file, its sha256 checked."""
    path = harness.ROOT / config["weights"]
    digest = hashlib.sha256(path.read_bytes()).hexdigest()
    if digest != config["weights_sha256"]:
        raise RuntimeError(f"{path} has sha256 {digest}, the configuration "
                           f"pins {config['weights_sha256']}")
    return path


def load_model(config: dict, device: str):
    """The program's EdgeUNet with the configuration's weights."""
    from image_compression_torch.models.unet import EdgeUNet
    from image_compression_torch.train.checkpoint import load_params
    m = config["model"]
    model = EdgeUNet(base=m["base"], edge_channels=m["edge_channels"],
                     dtype=getattr(torch, m["conv_dtype"]))
    model.load_state_dict(load_params(weights_path(config)))
    return model.to(device)


def _dir_bytes(path: pathlib.Path) -> int:
    return sum(f.stat().st_size for f in path.iterdir())


class Run:
    def __init__(self, spec: dict, seed: int, device: str,
                 workdir: pathlib.Path):
        self.spec = spec
        self.config = spec["config"]
        self.traffic = spec["traffic"]
        self.seed = seed
        self.device = device
        self.workdir = workdir
        self.batch_size = self.config["batch_size"]
        self.check_job = seed % 2
        self.attempted = 0
        self.failed = 0
        self.captured: list = []
        self.solved: list = []

    def setup(self) -> None:
        from image_compression_torch import pipeline
        from image_compression_torch.config import Config
        self.pipeline = pipeline
        corpus_dir = self.workdir / "corpus"
        self.corpus = generator.make(self.traffic, self.seed, corpus_dir)
        self.model = load_model(self.config, self.device).eval()
        self.cfg = Config.from_dict(self.config["settings"])
        self.cfg.dataset_dir = str(corpus_dir)
        self._job(corpus_dir, self.workdir / "warm_out")
        shutil.rmtree(self.workdir / "warm_out")

    def _job(self, dataset: pathlib.Path, out: pathlib.Path,
             timings: dict | None = None) -> list[pathlib.Path]:
        self.cfg.dataset_dir = str(dataset)
        self.cfg.results_dir = str(out)
        return self.pipeline.compress_directory(
            self.cfg, model=self.model, batch_size=self.batch_size,
            device=self.device, timings=timings)

    def _capture(self, _module, args, out) -> None:
        self.captured.append((args[0], out))

    def _kept_job(self, dataset: pathlib.Path, out: pathlib.Path,
                  timings: dict | None = None) -> list[pathlib.Path]:
        """A job that keeps what the check compares: the U-Net's inputs and
        outputs, and each batch's cost planes and labels from the solver."""
        pipe = self.pipeline
        solve = pipe.segment_batch

        def kept(costs, *a, **k):
            labels = solve(costs, *a, **k)
            self.solved.append((costs.clone(), labels.clone()))
            return labels

        hook = self.model.register_forward_hook(self._capture)
        pipe.segment_batch = kept
        try:
            return self._job(dataset, out, timings)
        finally:
            pipe.segment_batch = solve
            hook.remove()

    def window(self, seconds: float, timings: bool = False) -> dict:
        corpus_dir = self.workdir / "corpus"
        self.timings = {} if timings else None
        self.jobs: list[dict] = []
        self.job_s: list[float] = []
        while sum(self.job_s) < seconds:
            j = len(self.jobs)
            out = self.workdir / f"out{j}"
            job = self._kept_job if j == self.check_job else self._job
            t0 = time.perf_counter()
            dirs = job(corpus_dir, out, self.timings)
            self.job_s.append(time.perf_counter() - t0)
            print(f"job {j} {self.job_s[-1]:.6f} s", file=sys.stderr)
            self.jobs.append({d.name: _dir_bytes(d) for d in dirs})
            if j != self.check_job:
                shutil.rmtree(out)
        n = len(self.corpus)
        self.attempted = n * len(self.jobs)
        # an image whose output never came
        self.failed = sum(1 for sizes in self.jobs for stem in self.corpus
                          if stem not in sizes)
        if self.check_job >= len(self.jobs):
            raise RuntimeError(f"the window ran {len(self.jobs)} job(s); the "
                               f"checked job is job {self.check_job}")
        first = self.jobs[0]
        orig = sum(rec["png_bytes"] for rec in self.corpus.values())
        return {"images_per_s": (self.attempted - self.failed)
                / sum(self.job_s),
                "out_orig": sum(first.get(s, 0) for s in self.corpus) / orig}

    def profile(self) -> dict | None:
        """One job under torch.profiler, the pipeline's stages in benchmark
        ranges, without the stage clocks."""
        pipe = self.pipeline
        saved = {name: getattr(pipe, name) for name, _ in STAGES}

        def ranged(fn, stage):
            def call(*a, **k):
                with trace.stage(stage):
                    return fn(*a, **k)
            return call

        for name, stage in STAGES:
            setattr(pipe, name, ranged(saved[name], stage))
        out = self.workdir / "trace_out"
        try:
            summary = trace.profile(
                lambda: self._job(self.workdir / "corpus", out))
        finally:
            for name, fn in saved.items():
                setattr(pipe, name, fn)
            shutil.rmtree(out, ignore_errors=True)
        return summary

    def context(self, summary: dict | None) -> dict:
        n = len(self.corpus)
        side = self.traffic["size"]
        batches = len(self.jobs) * -(-n // self.batch_size)
        return {"driver": "compress", "config": self.config,
                "timings": self.timings or {}, "timed_batches": batches,
                "trace": summary, "traced_images": n,
                "traced_batches": -(-n // self.batch_size),
                "height": side, "width": side, "cost": cost}

    def check(self) -> dict:
        from portbench.reference import compress as ref
        del self.model
        if self.device == "cuda":
            torch.cuda.empty_cache()
        return ref.check(self.spec, self.corpus,
                         self.workdir / f"out{self.check_job}",
                         self.captured, self.solved, self.device)
