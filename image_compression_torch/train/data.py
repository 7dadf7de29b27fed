"""Host input pipeline: threaded image loading feeding device batches.

Port of the reference's train/data.py: a prefetching thread pool over the
port's io/image_io, with an optional decoded-image RAM cache. Batches are
numpy arrays; the training loops move them to the device. Two modes:

  * pretrain: yields images [B, H, W, 3] f32 in [0, 1] (with
    yield_indices, (images, indices)); the classical targets are computed
    on the device by ops/targets.py;
  * rl: yields (images, file_sizes [B] f32), the on-disk byte sizes.

The shuffle order of epoch e is numpy's default_rng(seed + e).shuffle, the
reference's order. Images are center-cropped and resized (nearest) to the
training resolution where needed.
"""

from __future__ import annotations

import concurrent.futures
import os
import pathlib
import queue
import threading
from typing import Iterator

import numpy as np

from image_compression_torch.io.image_io import load_image, to_float01_rgb


def _load_example(path: pathlib.Path, size: int | None,
                  with_file_size: bool):
    img = to_float01_rgb(load_image(path))
    if size is not None and img.shape[:2] != (size, size):
        img = _center_crop_resize(img, size)
    if with_file_size:
        return img, float(os.path.getsize(path))
    return img, None


def _center_crop_resize(img: np.ndarray, size: int) -> np.ndarray:
    """Nearest-neighbor resize of the center square crop."""
    h, w = img.shape[:2]
    side = min(h, w)
    y0 = (h - side) // 2
    x0 = (w - side) // 2
    crop = img[y0:y0 + side, x0:x0 + side]
    idx = (np.arange(size) * side // size).clip(max=side - 1)
    return crop[idx][:, idx]


class ImageBatches:
    """Iterable over shuffled, prefetched batches."""

    def __init__(self, paths: list[pathlib.Path], batch_size: int,
                 image_size: int | None = None, with_file_sizes: bool = False,
                 workers: int = 4, drop_last: bool = True, seed: int = 0,
                 prefetch: int = 4, yield_indices: bool = False,
                 cache_bytes: int = 0):
        self.paths = list(paths)
        self.batch_size = batch_size
        self.image_size = image_size
        self.with_file_sizes = with_file_sizes
        self.workers = workers
        self.drop_last = drop_last
        self.seed = seed
        self.prefetch = prefetch
        self.yield_indices = yield_indices
        # decoded-image RAM cache (PNG decoding dominates the host loop on
        # machines with few cores), bounded by cache_bytes; 0 disables
        self.cache_bytes = cache_bytes
        self._cache: dict[int, tuple] = {}
        self._cache_used = 0
        self._cache_lock = threading.Lock()

    def _example(self, idx: int):
        hit = self._cache.get(idx)
        if hit is not None:
            return hit
        ex = _load_example(self.paths[idx], self.image_size,
                           self.with_file_sizes)
        if self.cache_bytes:
            with self._cache_lock:
                if (idx not in self._cache
                        and self._cache_used + ex[0].nbytes
                        <= self.cache_bytes):
                    self._cache[idx] = ex
                    self._cache_used += ex[0].nbytes
        return ex

    def __len__(self):
        n = len(self.paths) // self.batch_size
        if not self.drop_last and len(self.paths) % self.batch_size:
            n += 1
        return n

    def epoch(self, epoch: int = 0, shuffle: bool = True) -> Iterator:
        order = np.arange(len(self.paths))
        if shuffle:
            np.random.default_rng(self.seed + epoch).shuffle(order)
        batches = [order[i:i + self.batch_size]
                   for i in range(0, len(order), self.batch_size)]
        if self.drop_last and batches and len(batches[-1]) < self.batch_size:
            batches.pop()

        out_q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put_checking_stop(item) -> bool:
            # never block forever on a full queue: a consumer that abandons
            # the iterator sets `stop`, and the producer must notice even
            # mid-put or it leaks the thread + its pool
            while not stop.is_set():
                try:
                    out_q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            with concurrent.futures.ThreadPoolExecutor(self.workers) as pool:
                for idxs in batches:
                    if stop.is_set():
                        return
                    examples = list(pool.map(self._example, idxs))
                    images = np.stack([e[0] for e in examples])
                    item: tuple = (images,)
                    if self.with_file_sizes:
                        item += (np.asarray([e[1] for e in examples],
                                            np.float32),)
                    if self.yield_indices:
                        item += (np.asarray(idxs, np.int64),)
                    if not put_checking_stop(item if len(item) > 1
                                             else item[0]):
                        return
            put_checking_stop(None)

        thread = threading.Thread(target=produce, daemon=True)
        thread.start()
        try:
            while True:
                item = out_q.get()
                if item is None:
                    return
                yield item
        finally:
            stop.set()
