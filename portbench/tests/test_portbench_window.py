"""The compress window: its clock runs around the program's calls alone,
and the warm-up is one whole job that the window does not count."""

import pathlib
import re
import shutil
import time
import types

import pytest
import torch

from portbench import harness
from portbench.drivers import compress
from portbench.tests import tiny


def _stub_run(tmp_path, call_s, images=4, seed=7):
    """A compress Run whose program is a stub: each call takes `call_s`
    and writes one small directory per image."""
    corpus = {f"im{i}": {"png_bytes": 100} for i in range(images)}
    stems = list(corpus)

    def compress_directory(cfg, **_kw):
        time.sleep(call_s)
        dirs = []
        for stem in stems:
            d = pathlib.Path(cfg.results_dir) / stem
            d.mkdir(parents=True)
            (d / "metadata.bin").write_bytes(bytes(10))
            dirs.append(d)
        return dirs

    run = compress.Run({"config": {"batch_size": 8}, "traffic": {}}, seed,
                       "cpu", tmp_path)
    run.pipeline = types.SimpleNamespace(
        compress_directory=compress_directory, segment_batch=None)
    run.cfg = types.SimpleNamespace()
    run.model = torch.nn.Identity()
    run.corpus = corpus
    return run


def test_window_times_only_the_programs_calls(tmp_path, monkeypatch,
                                              capsys):
    """Sizing and deleting a job's outputs take twice as long as the
    program's call, and images_per_s counts only the call."""
    call_s, fs_s, images = 0.05, 0.05, 4
    sized, remove = compress._dir_bytes, shutil.rmtree

    def slow_size(path):
        time.sleep(fs_s / images)
        return sized(path)

    def slow_rmtree(path):
        time.sleep(fs_s)
        remove(path)

    monkeypatch.setattr(compress, "_dir_bytes", slow_size)
    monkeypatch.setattr(compress, "shutil", types.SimpleNamespace(
        rmtree=slow_rmtree))
    run = _stub_run(tmp_path, call_s, images)
    t0 = time.perf_counter()
    e2e = run.window(0.3)
    wall = time.perf_counter() - t0
    jobs = run.job_s
    assert all(s >= call_s for s in jobs)
    # every job that started before the summed seconds reached the window
    assert sum(jobs[:-1]) < 0.3 <= sum(jobs)
    assert wall >= sum(jobs) + (len(jobs) - 1.5) * 2 * fs_s
    assert run.attempted == images * len(jobs) and run.failed == 0
    assert e2e["images_per_s"] == pytest.approx(run.attempted / sum(jobs))
    assert e2e["images_per_s"] > 0.6 * images / call_s  # not / (call + fs)
    assert e2e["out_orig"] == pytest.approx(10 / 100)
    # each job's seconds on standard error; the checked job's output kept
    err = capsys.readouterr().err
    printed = [float(s) for s in re.findall(r"^job \d+ ([0-9.]+) s$", err,
                                            re.M)]
    assert printed == pytest.approx(jobs, abs=1e-6)
    kept = [p.name for p in tmp_path.iterdir() if p.name.startswith("out")]
    assert kept == [f"out{run.check_job}"]


def test_an_image_that_never_came_is_not_completed(tmp_path):
    run = _stub_run(tmp_path, 0.01, images=4)
    run.corpus["missing"] = {"png_bytes": 100}
    e2e = run.window(0.05)
    assert run.failed == len(run.jobs)
    assert e2e["images_per_s"] == pytest.approx(
        4 * len(run.jobs) / sum(run.job_s))


def test_warm_up_is_one_whole_job_outside_the_window(monkeypatch):
    from image_compression_torch import pipeline
    real = pipeline.compress_directory
    calls = []

    def counted(cfg, **kw):
        dirs = real(cfg, **kw)
        calls.append((pathlib.Path(cfg.results_dir).name, len(dirs)))
        return dirs

    monkeypatch.setattr(pipeline, "compress_directory", counted)
    torch.set_num_threads(2)
    images = 12     # a batch of 8 and a partial batch
    result = harness.run_cell(
        "flagship.mixed1024", 4, 0.5, False, device="cpu",
        spec=tiny.spec("flagship.mixed1024", images=images))
    assert result["correct"]
    assert calls[0] == ("warm_out", images)      # the whole corpus
    window = calls[1:]
    assert [name for name, _ in window] == [f"out{j}"
                                            for j in range(len(window))]
    assert result["attempted"] == images * len(window)
