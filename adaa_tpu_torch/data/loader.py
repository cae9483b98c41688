"""Batched prefetching data loader (a copy of ``adaa_tpu/data/loader.py``).

A thread-pool decode + prefetch pipeline in place of the reference's
``torch.utils.data.DataLoader(num_workers=6)`` (src/trainer.py:92-105):
items are decoded on host threads while the previous batch runs on the
device. Batches come out as stacked numpy arrays (wave (B, 64600) f32, sr
(B,) i32, label (B,) i32[, meta tuple-of-lists]); the caller moves them
to its device. The shuffle order is drawn from numpy's global generator,
so one ``np.random.seed`` gives this loader and the JAX package's the
same batches.
"""
from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, List, Optional

import numpy as np


class DataLoader:
    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = True,
        drop_last: bool = True,
        num_workers: int = 6,
        seed: Optional[int] = None,
        prefetch_batches: int = 2,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = max(1, num_workers)
        self.prefetch_batches = prefetch_batches
        if seed is None and shuffle:
            # torch's DataLoader draws its shuffle order from the
            # set_seed-seeded global generator (the reference's
            # determinism contract: utils.py set_seed -> torch RNG ->
            # sampler); default_rng(None) would use OS entropy and make
            # training batch order irreproducible. One global draw per
            # shuffling loader mirrors the torch consumption pattern.
            seed = int(np.random.randint(0, 2**31 - 1))
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def _batch_indices(self) -> List[np.ndarray]:
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            self._rng.shuffle(order)
        batches = []
        for i in range(0, n, self.batch_size):
            chunk = order[i : i + self.batch_size]
            if len(chunk) < self.batch_size and self.drop_last:
                continue
            batches.append(chunk)
        return batches

    @staticmethod
    def _collate(items):
        waves = np.stack([np.asarray(it[0], np.float32) for it in items])
        srs = np.asarray([it[1] for it in items], np.int32)
        out = [waves, srs]
        if len(items[0]) > 2:
            out.append(np.asarray([it[2] for it in items], np.int32))
        if len(items[0]) > 3:
            metas = [it[3] for it in items]
            out.append(tuple(zip(*metas)))  # tuple of per-field tuples
        return out

    def __iter__(self) -> Iterator:
        batches = self._batch_indices()
        if not batches:
            return
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch_batches)
        sentinel = object()

        def produce():
            with ThreadPoolExecutor(self.num_workers) as pool:
                for idx in batches:
                    items = list(pool.map(self.dataset.__getitem__, idx))
                    q.put(self._collate(items))
            q.put(sentinel)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is sentinel:
                break
            yield item
        t.join()
