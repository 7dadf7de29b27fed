"""The CUDA source of the multicut leaf (csrc/multicut_leaf.cu), compiled
for the CPU and held bitwise to `leaf_plain`.

There is no nvcc and no GPU here, so the source is compiled by the host C++
compiler against tests/cuda_cpu_shim/, which stands in for the CUDA headers:
each CUDA thread of a block is an OS thread, barriers are std::barriers,
ballots and atomics are emulated. What this checks is the kernel's own code
(indexing, barriers, list layout, ballots) on the shapes and cases of the
card checks in chip_smoke.py, not nvcc or the hardware; those are checked
on the card by chip_smoke.py and tests/test_torch_cuda.py. The kernel runs
in a subprocess with a time limit, so that a barrier mismatch fails the
test instead of hanging the suite."""

import pathlib
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from image_compression_torch.ops import multicut_leaf as leaf

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
SHIM = REPO / "tests" / "cuda_cpu_shim"
FIELDS = ("rank", "gid", "sym", "m", "ncand", "over")

RUNNER = r"""
import ctypes, sys
import numpy as np
lib = ctypes.CDLL(sys.argv[1])
fn = lib.multicut_leaf_launch
fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
data = np.load(sys.argv[2])
s1, r0, r1, n_pix = (int(v) for v in data["params"])
ins = [np.ascontiguousarray(data[k], np.float32)
       for k in ("w0h", "w0v", "wmid", "pix")]
t1 = ins[0].shape[0]
outs = [np.full((t1, 4, 64), -7, np.int32), np.full((t1, 4, 64), -7, np.int32),
        np.full((t1, s1, s1), 99.0, np.float32),
        np.full((t1, s1), 99.0, np.float32),
        np.full(t1, -7, np.int32), np.full(t1, -7, np.int32)]
for _ in range(int(sys.argv[4])):
    err = fn(*(a.ctypes.data for a in ins + outs), t1, s1, r0, r1, n_pix,
             None)
    assert err == 0, err
    np.savez(sys.argv[3] + str(_), *outs)
"""


@pytest.fixture(scope="module")
def library(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("clang++")
    if cxx is None:
        pytest.skip("needs a host C++20 compiler (g++ or clang++)")
    src = (REPO / "image_compression_torch" / "csrc" /
           "multicut_leaf.cu").read_text()
    src, launches = re.subn(r"(\w+)<<<(.*?)>>>\((.*?)\);",
                            r"emu_launch(\2, [&] { \1(\3); });", src,
                            flags=re.S)
    assert launches >= 1
    out = tmp_path_factory.mktemp("leaf_source")
    (out / "multicut_leaf.cpp").write_text(src)
    proc = subprocess.run(
        [cxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread",
         "-Wno-unknown-pragmas", f"-I{SHIM}", "-x", "c++",
         str(out / "multicut_leaf.cpp"), "-o", str(out / "libleaf.so")],
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    (out / "runner.py").write_text(RUNNER)
    return out


def _run(library, args, repeats=1):
    """The compiled kernel on leaf_plain's arguments, in a subprocess;
    returns the outputs of each launch as tensors."""
    w0h, w0v, wmid, pix, s1, r0, r1, n_pix = args
    np.savez(library / "in.npz", w0h=w0h.numpy(), w0v=w0v.numpy(),
             wmid=wmid.numpy(), pix=pix.numpy(),
             params=np.array([s1, r0, r1, n_pix]))
    proc = subprocess.run(
        [sys.executable, str(library / "runner.py"),
         str(library / "libleaf.so"), str(library / "in.npz"),
         str(library / "out"), str(repeats)],
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-4000:]
    runs = []
    for i in range(repeats):
        with np.load(library / f"out{i}.npz") as got:
            runs.append([torch.as_tensor(got[f"arr_{j}"])
                         for j in range(len(FIELDS))])
    return runs


def _costs(kind, shape):
    rng = np.random.default_rng([len(kind), *shape])
    if kind == "heavy":
        return -np.abs(rng.normal(size=shape + (2,))) - 0.1
    if kind == "heavy_int":  # nothing merges: most regions freeze
        return -rng.integers(1, 9, size=shape + (2,))
    low, high = {"int": (-8, 9), "ties": (-1, 2), "attractive": (-2, 9)}[kind]
    return rng.integers(low, high, size=shape + (2,))


@pytest.mark.parametrize("kind,shape,s1,rounds", [
    ("int", (2, 32, 64), 64, (2, 1)),
    ("int", (2, 32, 64), 128, (2, 1)),
    ("ties", (2, 32, 32), 64, (2, 1)),
    ("heavy", (2, 32, 32), 64, (2, 1)),
    ("int", (3, 48, 48), 64, (2, 1)),       # ragged: 27 supertiles
    ("int", (1, 32, 32), 64, (0, 0)),
    ("attractive", (1, 32, 32), 128, (3, 2)),
    ("int", (1, 32, 32), 33, (2, 1)),       # an odd level-1 cap
    ("int", (1, 64, 64), 64, (2, 1)),
    ("int", (1, 64, 64), 128, (2, 1)),
    ("ties", (1, 64, 64), 64, (2, 1)),
    ("ties", (1, 64, 64), 128, (2, 1)),
    ("int", (1, 32, 32), 64, (3, 2)),
    ("int", (1, 32, 32), 128, (0, 0)),
    ("heavy_int", (1, 32, 16), 64, (2, 1)),
    ("attractive", (1, 16, 32), 128, (2, 1)),
])
def test_source_matches_plain(library, kind, shape, s1, rounds):
    """Every output of the compiled source equals leaf_plain's bit for
    bit."""
    costs = torch.as_tensor(_costs(kind, shape).astype(np.float32))
    args = (*leaf.leaf_inputs(costs), s1, *rounds, shape[1] * shape[2])
    (got,) = _run(library, args)
    for name, g, w in zip(FIELDS, got, leaf.leaf_plain(*args)):
        assert torch.equal(g, w), name


def test_source_repeats_on_real_costs(library):
    """Sums run in a fixed order: two launches on real-valued costs agree
    bit for bit."""
    costs = torch.as_tensor(np.random.default_rng(1).normal(
        size=(1, 32, 32, 2)).astype(np.float32))
    first, second = _run(library, (*leaf.leaf_inputs(costs), 64, 2, 1,
                                   32 * 32), repeats=2)
    for a, b in zip(first, second):
        assert torch.equal(a, b)
