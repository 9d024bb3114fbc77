"""Host-side batching (counterpart of
behindthescenes_tpu/datasets/loader.py:20-116): shuffling, batching and a
thread pool that makes items ahead of the caller and hands the batches
over in order.
"""
from __future__ import annotations

from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator

import numpy as np

from behindthescenes_tpu_torch.datasets.synthetic import collate


class DataLoader:
    """Batches of `batch_size` items, collated. shuffle: each epoch's order
    is a permutation drawn from default_rng(seed * 131071 + epoch), the
    JAX loader's draw (`set_epoch` picks the epoch); otherwise items
    0..len-1 in order. drop_last: the last batch is dropped when it is
    short. With num_workers > 0 a pool of that many threads makes the
    items of enough batches ahead (`prefetch`, and at least two items a
    worker) while the caller works on the current one; batches come out in
    order."""

    def __init__(self, dataset, batch_size: int = 1, shuffle: bool = False,
                 drop_last: bool = False, num_workers: int = 2,
                 seed: int = 0, prefetch: int = 2):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = max(0, num_workers)
        self.seed = seed
        self.prefetch = prefetch
        self._epoch = 0

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def set_epoch(self, epoch: int):
        self._epoch = epoch

    def index_batches(self) -> list:
        """This epoch's batches of item indices."""
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            rng = np.random.default_rng(self.seed * 131071 + self._epoch)
            rng.shuffle(order)
        end = (n // self.batch_size) * self.batch_size if self.drop_last \
            else n
        return [order[i:i + self.batch_size]
                for i in range(0, end, self.batch_size)]

    def __iter__(self) -> Iterator[dict]:
        batches = iter(self.index_batches())
        if self.num_workers == 0:
            for idxs in batches:
                yield collate([self.dataset[int(i)] for i in idxs])
            return
        window = max(self.prefetch,
                     -(-2 * self.num_workers // self.batch_size))
        with ThreadPoolExecutor(max_workers=self.num_workers) as ex:
            pending = deque()

            def submit():
                idxs = next(batches, None)
                if idxs is not None:
                    pending.append([ex.submit(self.dataset.__getitem__,
                                              int(i)) for i in idxs])
            for _ in range(window):
                submit()
            try:
                while pending:
                    futures = pending.popleft()
                    submit()
                    yield collate([f.result() for f in futures])
            finally:
                for futures in pending:
                    for f in futures:
                        f.cancel()


class _Strided:
    """Items rank, rank + world, rank + 2 world, ... of a dataset: the
    first len(dataset) // world of them, or with `cover` every one (the
    ranks' shares then cover the dataset, the first ones an item
    longer)."""

    def __init__(self, dataset, rank: int, world: int, cover: bool = False):
        self.dataset = dataset
        self.rank = rank
        self.world = world
        n = len(dataset)
        self.length = -(-(n - rank) // world) if cover else n // world

    def __len__(self):
        return self.length

    def __getitem__(self, i):
        if not 0 <= i < self.length:
            raise IndexError(i)
        return self.dataset[i * self.world + self.rank]


def shard_for_host(dataset, host_id: int, num_hosts: int):
    """The rank's share of a training set (behindthescenes_tpu/datasets/
    loader.py:118-131, in place of DistributedSampler): items host_id +
    i * num_hosts, disjoint across ranks and without padding, the
    remainder of len(dataset) / num_hosts left out (17 items over 2 ranks
    give 8 each)."""
    return _Strided(dataset, host_id, num_hosts)


def split_for_rank(dataset, rank: int, world: int):
    """The rank's share of an evaluation set: items rank + i * world, the
    ranks' shares disjoint and covering every item (17 items over 2 ranks
    give 9 and 8)."""
    return _Strided(dataset, rank, world, cover=True)
