"""What the benchmark loads, and how it exits where it cannot measure."""

import json
import os
import pathlib
import shutil
import subprocess
import sys

from portbench import harness

ROOT = harness.ROOT

PROBE = """
import json, sys
sys.path.insert(0, {root!r})
{body}
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _loaded(body: str) -> set[str]:
    out = subprocess.run(
        [sys.executable, "-c", PROBE.format(root=str(ROOT), body=body)],
        capture_output=True, text=True, timeout=600, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=""))
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_reference_loads_nothing_of_the_program_or_jax():
    names = _loaded("import portbench.reference.compress, "
                    "portbench.reference.rl, portbench.pngcodec, "
                    "portbench.traffic.generator, portbench.cost.model, "
                    "portbench.control")
    assert not names & {"image_compression_torch", "image_compression_tpu",
                        "jax", "jaxlib", "flax"}


def test_a_whole_run_loads_no_jax():
    body = ("from portbench.tests import tiny\n"
            "r = tiny.run('flagship.mixed1024', seed=2, seconds=0.5)\n"
            "assert r['correct'], r")
    names = _loaded(body)
    assert "image_compression_torch" in names
    assert not names & set(harness.FORBIDDEN)


def _run(cwd, *extra):
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "flagship.mixed1024", "--seed", "3", "--seconds", "1", "--trace",
         "0", *extra], capture_output=True, text=True, timeout=600, cwd=cwd,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=""))


def test_exits_without_a_card_and_prints_no_result():
    out = _run(ROOT)
    assert out.returncode != 0 and out.stdout == ""
    assert "cuda" in out.stderr.lower()


def test_exits_where_only_the_benchmark_is(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0 and out.stdout == ""


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "image_compression_tpu_like", object())
    monkeypatch.setitem(sys.modules, "jaxtyping", object())
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert harness.forbidden_modules() == ["jax"]


def test_paths_hold_only_the_benchmark():
    tracked = subprocess.run(["git", "ls-files", "portbench"], cwd=ROOT,
                             capture_output=True, text=True).stdout.split()
    for name in tracked:
        assert pathlib.PurePosixPath(name).parts[0] == "portbench"
