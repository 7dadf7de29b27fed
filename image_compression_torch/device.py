"""Device resolution for the port's entry points.

Entry points take `device=` and default to CUDA. Nothing moves to the CPU
silently: asking for CUDA on a machine without a usable GPU raises; the CPU
runs only when the caller names it (as the tests do)."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """torch.device for `device`; raises if it names CUDA and none is
    available."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' requested but torch.cuda.is_available() is False; "
            "pass device='cpu' explicitly to run on the CPU")
    return dev
