"""Build and load the port's native libraries.

Each source exposes a plain C interface and is compiled into a shared
library that ctypes loads — no PyTorch headers, no build system:
  * a CUDA kernel `csrc/<name>.cu` by nvcc for sm_90a;
  * the host PNG writer `csrc/pngio.cpp` by g++ against zlib.
A library is built at first use into `csrc/build/` (ignored by git), under
a name keyed by a hash of the source and the flags, so a stale library is
never loaded. Processes building one library take an exclusive lock on a
sidecar file and link to a temporary name that is renamed into place, so
no process loads a partial library. A build takes seconds.
"""

from __future__ import annotations

import ctypes
import fcntl
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
GXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared")
GXX_LIBS = ("-lz", "-lpthread")

_loaded: dict[str, ctypes.CDLL] = {}


class BuildError(RuntimeError):
    """The compiler failed; `stderr` holds its output."""

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


def gxx_path() -> str | None:
    """g++ on PATH, or None."""
    return shutil.which("g++")


def zlib_header(gxx: str | None = None) -> str | None:
    """Path of the zlib.h the host compiler finds, or None."""
    gxx = gxx or gxx_path()
    if gxx is None:
        return None
    try:
        proc = subprocess.run([gxx, "-M", "-x", "c++", "-"],
                              input="#include <zlib.h>\n",
                              capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return None
    if proc.returncode != 0:
        return None
    return next((tok for tok in proc.stdout.split()
                 if tok.endswith("zlib.h")), None)


def source(name: str) -> pathlib.Path:
    """csrc/<name>.cu (a CUDA kernel) or csrc/<name>.cpp (host code)."""
    cu = CSRC / f"{name}.cu"
    return cu if cu.exists() else CSRC / f"{name}.cpp"


def _command(name: str, out: str) -> list[str]:
    src = source(name)
    if src.suffix == ".cu":
        return [nvcc_path(), *NVCC_FLAGS, "-o", out, str(src)]
    return [gxx_path() or "g++", *GXX_FLAGS, "-o", out, str(src), *GXX_LIBS]


def library_path(name: str) -> pathlib.Path:
    src = source(name)
    flags = NVCC_FLAGS if src.suffix == ".cu" else GXX_FLAGS + GXX_LIBS
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(flags).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(name: str) -> tuple[pathlib.Path, str]:
    """Compile csrc/<name>.cu (nvcc) or csrc/<name>.cpp (g++) unless its
    library exists. Returns (library path, the compiler's stderr — for nvcc
    ptxas' resource usage — or "" if it was built before). Raises BuildError
    if the compiler fails or cannot run."""
    out = library_path(name)
    if out.exists():
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / f"{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released if the holder dies
        if out.exists():  # another process built it meanwhile
            return out, ""
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            cmd = _command(name, tmp)
            try:
                proc = subprocess.run(cmd, capture_output=True, text=True)
            except OSError as e:
                raise BuildError(f"cannot run {cmd[0]} for {name}",
                                 str(e)) from e
            if proc.returncode != 0:
                raise BuildError(f"{cmd[0]} failed for {name} "
                                 f"(exit {proc.returncode})", proc.stderr)
            os.replace(tmp, out)  # atomic: no process sees a partial file
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    return out, proc.stderr


def load(name: str) -> ctypes.CDLL:
    """The library of csrc/<name>.cu or .cpp, built at first use and
    loaded once per process."""
    lib = _loaded.get(name)
    if lib is None:
        path, _ = build(name)
        lib = _loaded[name] = ctypes.CDLL(str(path))
    return lib
