"""Streaming, shuffled, prefetched training batches (port of
`tdvnet/train/loader.py`) over the port's `data.dataset.Dataset`.

Every epoch draws a scene order from `np.random.default_rng((seed,
epoch))`, the JAX package's rule, so both packages visit the scenes in the
same order; worker threads assemble the next batches while the card
computes.
"""
from __future__ import annotations

import concurrent.futures as cf
from typing import Iterator, Optional, Sequence

import numpy as np

from tdvnet_torch.data.batch import FrameBatch


class StreamingLoader:
    """Per-epoch shuffled FrameBatch stream with threaded prefetch.

    dset: the port's `Dataset` (or anything with `get_batch` and `len`).
    """

    def __init__(self, dset, n_scenes: int, n_views: int, n_ref: int,
                 seed: int = 0, prefetch: int = 3, workers: int = 4,
                 steps_per_epoch: Optional[int] = None,
                 drop_last: bool = True):
        self.dset = dset
        self.n_scenes = n_scenes
        self.n_views = n_views
        self.n_ref = n_ref
        self.seed = seed
        self.prefetch = max(prefetch, 1)
        self.workers = max(workers, 1)
        n = len(dset)
        full = n // n_scenes if drop_last else -(-n // n_scenes)
        self.steps = min(full, steps_per_epoch) if steps_per_epoch else full
        if self.steps < 1:
            raise ValueError(
                f"{n} scenes < batch size {n_scenes}: no full batch")

    def __len__(self) -> int:
        return self.steps

    def epoch_groups(self, epoch: int) -> Sequence[np.ndarray]:
        """The scene indices of each of the epoch's batches."""
        rng = np.random.default_rng((self.seed, epoch))
        order = rng.permutation(len(self.dset))
        return [order[i * self.n_scenes:(i + 1) * self.n_scenes]
                for i in range(self.steps)]

    def epoch(self, epoch: int) -> Iterator[FrameBatch]:
        """Yield this epoch's batches in order, up to `prefetch` of them
        built ahead on worker threads."""
        groups = self.epoch_groups(epoch)

        def build(idx):
            return self.dset.get_batch(idx, self.n_views, self.n_ref)

        with cf.ThreadPoolExecutor(self.workers) as pool:
            pending = [pool.submit(build, g) for g in groups[:self.prefetch]]
            nxt = self.prefetch
            for _ in range(len(groups)):
                fut = pending.pop(0)
                if nxt < len(groups):
                    pending.append(pool.submit(build, groups[nxt]))
                    nxt += 1
                yield fut.result()
