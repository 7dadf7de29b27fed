"""The RL cell: REINFORCE steps of the program's
`image_compression_torch.train.steps.RLStep`, fed as
`train/reinforce.run_reinforce` feeds them.

Set-up writes the cell's corpus from the seed, loads the configuration's
weights into the program's EdgeUNet, builds the RL state
(`steps.init_rl_state`), the step and the batches (`train/data.ImageBatches`
over the corpus, batch B, epoch e shuffled by numpy's default_rng(e),
decoded once into its RAM cache). It warms up every shape with the first
WARM_STEPS batches on a fresh state around a copy of the model, through
the same step object, so that the state handed to the window still holds the loaded
weights, a fresh Adam and an uninitialized baseline. The window runs steps
with the key `prng.prng_key(seed)` from the first batch of epoch 0 until
--seconds have passed (and at least CHECKED_STEPS steps), synchronizing
the device once at the end of each step; a step's time is read from CUDA
events around it. The window's own first CHECKED_STEPS steps are the ones
the reference follows: each step's sample and rewards as
`RLStep.solve_reward` returns them, Adam's first moment after the first and
the parameters after the last are kept.
Per-epoch evaluation and checkpoint saves are driver work outside the step
and are left out.
"""

from __future__ import annotations

import copy
import itertools
import pathlib
import statistics
import time

import torch

from portbench import trace
from portbench.cost import model as cost
from portbench.drivers.compress import load_model
from portbench.traffic import generator

WARM_STEPS = 2
CHECKED_STEPS = 3
TRACED_STEPS = 10


class Run:
    def __init__(self, spec: dict, seed: int, device: str,
                 workdir: pathlib.Path):
        self.spec = spec
        self.config = spec["config"]
        self.traffic = spec["traffic"]
        self.seed = seed
        self.device = device
        self.workdir = workdir
        self.attempted = 0
        self.failed = 0

    def _batches(self):
        for epoch in itertools.count():
            yield from self.data.epoch(epoch)

    def _step(self, state, feed, timings=None):
        images, sizes = next(feed)
        imgs = torch.as_tensor(images).to(self.device, non_blocking=True)
        szs = torch.as_tensor(sizes).to(self.device, non_blocking=True)
        _, aux = self.step_fn(state, self.key, imgs, szs, timings=timings)
        return aux

    def setup(self) -> None:
        from image_compression_torch.config import Config
        from image_compression_torch.io.image_io import \
            find_image_files_recursively
        from image_compression_torch.ops import prng
        from image_compression_torch.train.data import ImageBatches
        from image_compression_torch.train.steps import (init_rl_state,
                                                         make_rl_step)
        corpus_dir = self.workdir / "train"
        self.corpus = generator.make(self.traffic, self.seed, corpus_dir)
        cfg = Config.from_dict(self.config["settings"])
        cfg.dataset_dir = str(corpus_dir)
        self.cfg = cfg
        self.model = load_model(self.config, self.device)
        self.state = init_rl_state(self.model, cfg)
        self.step_fn = make_rl_step(cfg)
        self.key = prng.prng_key(self.seed)
        paths = find_image_files_recursively(cfg.dataset_dir,
                                             cfg.image_format)
        paths = paths[:cfg.rl.max_train_images]
        self.data = ImageBatches(paths, cfg.rl.batch_size, cfg.image_size,
                                 with_file_sizes=True, workers=4,
                                 drop_last=True, cache_bytes=4 << 30)
        for _ in self.data.epoch(0, shuffle=False):
            pass  # decode the corpus into the loader's cache
        warm = init_rl_state(copy.deepcopy(self.model), cfg)
        warm_feed = self._batches()
        for _ in range(WARM_STEPS):
            self._step(warm, warm_feed)
        warm_feed.close()
        del warm, warm_feed
        self.feed = self._batches()

    def _keep(self, got: dict):
        """Wraps the step's solve_reward to keep each step's sample and
        rewards as returned; returns the undo."""
        solve_reward = self.step_fn.solve_reward

        def kept(*a, **k):
            w, rewards = solve_reward(*a, **k)
            got["w"].append(w.clone())
            got["reward"].append(rewards.clone())
            return w, rewards

        self.step_fn.solve_reward = kept
        return lambda: delattr(self.step_fn, "solve_reward")

    def window(self, seconds: float, timings: bool = False) -> dict:
        self.timings = {} if timings else None
        cuda = self.device == "cuda"
        if cuda:
            ev0 = torch.cuda.Event(enable_timing=True)
            ev1 = torch.cuda.Event(enable_timing=True)
        times, losses = [], []
        named = dict(self.model.named_parameters())
        got = {"reward": [], "w": []}
        undo = self._keep(got)
        t0 = time.perf_counter()
        while (time.perf_counter() - t0 < seconds
               or len(times) < CHECKED_STEPS):
            if cuda:
                ev0.record()
            else:
                h0 = time.perf_counter()
            aux = self._step(self.state, self.feed, self.timings)
            if cuda:
                ev1.record()
                ev1.synchronize()
                times.append(ev0.elapsed_time(ev1))
            else:
                times.append(1e3 * (time.perf_counter() - h0))
            losses.append(aux["loss"])
            if len(times) == 1:
                st = self.state.optimizer.state
                b1 = self.state.optimizer.param_groups[0]["betas"][0]
                got["grad1"] = {
                    k: (st[p]["exp_avg"] / (1 - b1) if "exp_avg" in st[p]
                        else torch.zeros_like(p)) for k, p in named.items()}
            if len(times) == CHECKED_STEPS:
                undo()
                got["params"] = {k: p.detach().clone()
                                 for k, p in named.items()}
        window_s = time.perf_counter() - t0
        self.got = got
        self.attempted = len(times)
        self.failed = int(sum(not torch.isfinite(x) for x in losses))
        return {"steps_per_s": len(times) / window_s,
                "step_p95_ms": (statistics.quantiles(
                    times, n=100, method="inclusive")[94]
                    if len(times) > 1 else times[0])}

    def profile(self) -> dict | None:
        """TRACED_STEPS steps under torch.profiler, the step's three
        stages in benchmark ranges, without the stage clock."""
        fn = self.step_fn

        def ranged(name):
            method = getattr(fn, name)

            def call(*a, **k):
                with trace.stage(name):
                    return method(*a, **k)
            return call

        for name in ("forward", "solve_reward", "update"):
            setattr(fn, name, ranged(name))
        try:
            return trace.profile(
                lambda: [self._step(self.state, self.feed)
                         for _ in range(TRACED_STEPS)])
        finally:
            for name in ("forward", "solve_reward", "update"):
                delattr(fn, name)

    def context(self, summary: dict | None) -> dict:
        b = self.config["batch_size"]
        side = self.config["settings"]["image_size"]
        pairs = 2 if self.config["settings"]["rl"]["sampler"] == \
            "antithetic" else 1
        return {"driver": "rl", "config": self.config,
                "timings": self.timings or {},
                "timed_steps": max(self.attempted, 1), "trace": summary,
                "traced_steps": TRACED_STEPS, "batch_size": b,
                "traced_solves": TRACED_STEPS * pairs * b,
                "height": side, "width": side, "cost": cost}

    def check(self) -> dict:
        from portbench.reference import rl as ref
        self.feed.close()
        del self.state, self.model, self.step_fn
        if self.device == "cuda":
            torch.cuda.empty_cache()
        return ref.check(self.spec, self.corpus, self.seed, self.got,
                         self.device)
