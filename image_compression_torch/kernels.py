"""Build and load the port's CUDA kernels.

Each kernel source `csrc/<name>.cu` exposes a plain C interface and is
compiled by nvcc for sm_90a into a shared library that ctypes loads — no
PyTorch headers, no build system. The library is built at first use into
`csrc/build/` (ignored by git), under a name keyed by a hash of the source
and the flags, so a stale library is never loaded. A build takes seconds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = CSRC / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_loaded: dict[str, ctypes.CDLL] = {}


class BuildError(RuntimeError):
    """nvcc failed; `stderr` holds its output."""

    def __init__(self, message: str, stderr: str):
        super().__init__(f"{message}\n{stderr}")
        self.stderr = stderr


def nvcc_path() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, then nvcc on PATH, then the
    toolkit's default install location."""
    for var in ("CUDA_HOME", "CUDA_PATH"):
        root = os.environ.get(var)
        if root and (pathlib.Path(root) / "bin" / "nvcc").exists():
            return str(pathlib.Path(root) / "bin" / "nvcc")
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


def library_path(name: str) -> pathlib.Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(name: str) -> tuple[pathlib.Path, str]:
    """Compile csrc/<name>.cu unless its library exists. Returns (library
    path, nvcc's stderr — ptxas resource usage — or "" if it was built
    before). Raises BuildError if nvcc fails."""
    out = library_path(name)
    if out.exists():
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True)
        except OSError as e:
            raise BuildError(f"cannot run nvcc for {name}", str(e)) from e
        if proc.returncode != 0:
            raise BuildError(f"nvcc failed for {name} "
                             f"(exit {proc.returncode})", proc.stderr)
        os.replace(tmp, out)  # atomic: concurrent builders never see a part
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out, proc.stderr


def load(name: str) -> ctypes.CDLL:
    """The kernel library of csrc/<name>.cu, built at first use and loaded
    once per process."""
    lib = _loaded.get(name)
    if lib is None:
        path, _ = build(name)
        lib = _loaded[name] = ctypes.CDLL(str(path))
    return lib
