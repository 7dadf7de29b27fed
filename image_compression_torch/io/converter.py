"""Dataset preparation: batch-convert images to the training format.

Port of the reference's io/converter.py (the `image_converter` tool): scan
for SOURCE_FORMAT images, resize each to a fixed size, and write it as a
PNG beside the source (suffix swapped), in a host thread pool. PNGs decode
through the port's codecs (io/image_io.py); other formats (JPEG, ...)
through PIL, imported only for them, and a clear error where it is
missing. The resize is torch's antialiased bilinear on `device`, in uint8
on the CPU and in float32 (rounded) on a GPU; it agrees with PIL's
BILINEAR within one level on most pixels, not bit for bit.
"""

from __future__ import annotations

import concurrent.futures
import os
import pathlib

import numpy as np
import torch
import torch.nn.functional as F

from image_compression_torch.device import resolve_device
from image_compression_torch.io.image_io import (decode_image_bytes,
                                                 find_image_files_recursively,
                                                 write_image)


def _to_rgb_u8(arr: np.ndarray) -> np.ndarray:
    """HWC uint8/uint16 with 1, 3 or 4 channels -> RGB uint8 (gray
    replicated, alpha dropped, 16-bit to its high byte)."""
    if arr.dtype == np.uint16:
        arr = (arr >> 8).astype(np.uint8)
    if arr.shape[2] == 1:
        arr = np.repeat(arr, 3, axis=2)
    return np.ascontiguousarray(arr[:, :, :3])


def _resize_rgb(image: np.ndarray, width: int, height: int,
               device: torch.device) -> np.ndarray:
    """Antialiased bilinear resize of an RGB uint8 image on `device`."""
    x = torch.as_tensor(image).permute(2, 0, 1)[None].to(device)
    if device.type == "cpu":  # torch's uint8 kernel, channels-last
        x = x.contiguous(memory_format=torch.channels_last)
        out = F.interpolate(x, size=(height, width), mode="bilinear",
                            antialias=True, align_corners=False)
    else:
        out = F.interpolate(x.float(), size=(height, width),
                            mode="bilinear", antialias=True,
                            align_corners=False)
        out = out.round().clamp(0, 255).to(torch.uint8)
    return out[0].permute(1, 2, 0).contiguous().cpu().numpy()


def convert_dataset(dataset_dir: str | pathlib.Path,
                    source_format: str = "jpeg", width: int = 256,
                    height: int = 256, compression_level: int = 4,
                    max_workers: int | None = None,
                    device: str | torch.device = "cuda") -> int:
    """Returns the number of images converted (the reference's defaults:
    jpeg -> 256x256 png). A file that fails to decode or write is printed
    and skipped."""
    dev = resolve_device(device)
    paths = find_image_files_recursively(dataset_dir, source_format)

    def convert(path: pathlib.Path) -> bool:
        try:
            rgb = _to_rgb_u8(decode_image_bytes(path.read_bytes()))
            return write_image(path.with_suffix(".png"),
                               _resize_rgb(rgb, width, height, dev),
                               compression_level)
        except (OSError, ValueError) as e:
            print(f"failed to convert {path}: {e}")
            return False

    workers = max_workers or min(8, os.cpu_count() or 1)
    with concurrent.futures.ThreadPoolExecutor(workers) as pool:
        results = list(pool.map(convert, paths))
    return int(np.sum(results))
