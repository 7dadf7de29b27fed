"""Checkpointing: params + optimizer state + step (+ RL baseline), with
torch.save.

Port of the reference's train/checkpoint.py under the same names:
<directory>/<phase>_<run_id>_<tag>, phases "fcn_pretrained" and
"fcn_training", tags "best", "epoch_N", "final", "interrupt", "latest" and
"best_params". A full-state file holds the state's `state_dict()` (params,
optimizer state, step; for RL also the baseline, its flag and the value
net); a params file (`save_params`) is a plain EdgeUNet state_dict, which
`compress --checkpoint` loads unchanged. Each file is written to a
temporary name and renamed into place, so a killed run leaves no partial
checkpoint.
"""

from __future__ import annotations

import os
import pathlib
import time

import torch


def new_run_id() -> str:
    """Unix-timestamp run id."""
    return str(int(time.time()))


def _atomic_save(obj, path: pathlib.Path) -> None:
    tmp = path.with_name(f".{path.name}.{os.getpid()}.tmp")
    torch.save(obj, tmp)
    tmp.replace(path)


class CheckpointManager:
    def __init__(self, directory: str | pathlib.Path, phase: str,
                 run_id: str | None = None):
        self.directory = pathlib.Path(directory).absolute()
        self.directory.mkdir(parents=True, exist_ok=True)
        self.phase = phase
        self.run_id = run_id or new_run_id()

    def _path(self, tag: str) -> pathlib.Path:
        return self.directory / f"{self.phase}_{self.run_id}_{tag}"

    def save(self, tag: str, state) -> pathlib.Path:
        """Full state (TrainState or RLState) under `tag`; loads on any device
        (restore_path maps it onto the state's)."""
        path = self._path(tag)
        _atomic_save(state.state_dict(), path)
        return path

    @staticmethod
    def restore_path(path: str | pathlib.Path, state):
        """Load a full-state checkpoint into `state` (in place, onto its
        device); returns it."""
        state.load_state_dict(torch.load(pathlib.Path(path).absolute(),
                                         map_location="cpu",
                                         weights_only=True))
        return state


def save_params(path: str | pathlib.Path, params) -> None:
    """A params-only checkpoint: an EdgeUNet state_dict."""
    _atomic_save(params, pathlib.Path(path).absolute())


_ORBAX_MARKERS = ("_CHECKPOINT_METADATA", "manifest.ocdbt")


def load_params(path: str | pathlib.Path) -> dict[str, torch.Tensor]:
    """The state_dict of a params file, or the params of a full-state
    checkpoint, on the CPU. An orbax checkpoint directory of the JAX
    package raises ValueError naming the command that converts it."""
    path = pathlib.Path(path).absolute()
    if path.is_dir() and any((path / m).exists() for m in _ORBAX_MARKERS):
        raise ValueError(
            f"{path} is an orbax checkpoint of the JAX package, which the "
            "port does not read; convert it once where orbax is installed: "
            f"python tests/test_torch_weights.py {path} <out.pt>")
    d = torch.load(path, map_location="cpu", weights_only=True)
    return d["params"] if "params" in d and "opt_state" in d else d
