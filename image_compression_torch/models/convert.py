"""Convert the reference's flax EdgeUNet parameters to a torch state_dict.

Input: the flax parameter tree as nested mappings of numpy arrays (with or
without the top-level "params" key), e.g. a checkpoint restored by the
reference package and mapped through numpy. Output: a state_dict for
models/unet.EdgeUNet. Layouts:

  * Conv kernels are HWIO -> torch OIHW;
  * ConvTranspose kernels (kh, kw, in, out) map to torch ConvTranspose2d
    (in, out, kh, kw) spatially FLIPPED: flax's ConvTranspose defaults to
    transpose_kernel=False, i.e. a plain convolution over the dilated input;
  * GroupNorm "scale" is torch's "weight".
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch


def _flatten(tree: Mapping, prefix: tuple = ()):
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _flatten(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def state_dict_from_flax(params: Mapping) -> dict[str, torch.Tensor]:
    """flax EdgeUNet params -> EdgeUNet state_dict (f32 tensors)."""
    if "params" in params:
        params = params["params"]
    out = {}
    for path, value in _flatten(params):
        arr = torch.from_numpy(np.array(value, dtype=np.float32))
        module, leaf = path[:-1], path[-1]
        if leaf == "kernel":
            if module[-1] == "up":  # ConvTranspose
                arr = arr.permute(2, 3, 0, 1).flip(-1, -2)
            else:
                arr = arr.permute(3, 2, 0, 1)
            leaf = "weight"
        elif leaf == "scale":
            leaf = "weight"
        out[".".join(module + (leaf,))] = arr.contiguous()
    return out
