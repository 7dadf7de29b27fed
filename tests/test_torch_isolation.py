"""The port runs where the reference's dependencies do not exist.

A subprocess blocks every import of jax, jaxlib, flax, optax, orbax,
tensorstore, PIL, triton, cv2 and the JAX reference package, imports every
module of image_compression_torch, and runs `chip_smoke.py --device cpu
--small` to its last line. The port's files are also searched for imports
of those packages."""

import json
import pathlib
import re
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent
BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "tensorstore", "PIL",
           "triton", "cv2", "image_compression_tpu")


def test_imports_and_smoke_without_reference_dependencies():
    script = (
        "import importlib, importlib.abc, pkgutil, runpy, sys\n"
        f"BLOCKED = {set(BLOCKED)!r}\n"
        "class Blocker(importlib.abc.MetaPathFinder):\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in BLOCKED:\n"
        "            raise ImportError('blocked: ' + name)\n"
        "        return None\n"
        "sys.meta_path.insert(0, Blocker())\n"
        f"sys.path.insert(0, {str(REPO)!r})\n"
        "import image_compression_torch\n"
        "for m in pkgutil.walk_packages(image_compression_torch.__path__,\n"
        "                               'image_compression_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "leaked = sorted(m for m in sys.modules\n"
        "                if m.split('.')[0] in BLOCKED)\n"
        "assert not leaked, leaked\n"
        f"sys.argv = [{str(REPO / 'chip_smoke.py')!r}, '--device', 'cpu',\n"
        "            '--small']\n"
        "runpy.run_path(sys.argv[0], run_name='__main__')\n")
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    last = json.loads(proc.stdout.strip().splitlines()[-1])
    assert last == {"ok": True, "device": last["device"]}
    assert last["device"]["platform"] == "cpu"


def test_no_reference_imports_in_the_port():
    """No import of a blocked package anywhere, except PIL, which may only
    be imported lazily (inside a function), never at module level."""
    anywhere = re.compile(r"^\s*(import|from)\s+(%s)\b" % "|".join(
        b for b in BLOCKED if b != "PIL"), re.M)
    module_level = re.compile(r"^(import|from)\s+PIL\b", re.M)
    files = sorted((REPO / "image_compression_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    for path in files:
        text = path.read_text()
        assert not anywhere.search(text), path
        assert not module_level.search(text), path
        if path.name != "chip_smoke.py":
            assert "image_compression_tpu" not in text, path
