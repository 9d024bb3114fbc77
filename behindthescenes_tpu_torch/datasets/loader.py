"""Host-side batching (counterpart of
behindthescenes_tpu/datasets/loader.py:18-40): batches of consecutive
items, collated, with optional thread prefetch."""
from __future__ import annotations

from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator

from behindthescenes_tpu_torch.datasets.synthetic import collate


# Batches made ahead of the caller when the loader has workers.
PREFETCH = 2


class DataLoader:
    """Items 0..len-1 in order, `batch_size` at a time (the last batch may
    be short). With num_workers > 0, a pool of that many threads makes the
    items of the next PREFETCH batches while the caller works on the
    current one."""

    def __init__(self, dataset, batch_size: int = 1, num_workers: int = 2):
        self.dataset = dataset
        self.batch_size = batch_size
        self.num_workers = max(0, num_workers)

    def __len__(self):
        return -(-len(self.dataset) // self.batch_size)

    def _index_batches(self):
        n = len(self.dataset)
        return [range(i, min(i + self.batch_size, n))
                for i in range(0, n, self.batch_size)]

    def __iter__(self) -> Iterator[dict]:
        batches = iter(self._index_batches())
        if self.num_workers == 0:
            for idxs in batches:
                yield collate([self.dataset[i] for i in idxs])
            return
        with ThreadPoolExecutor(max_workers=self.num_workers) as ex:
            pending = deque()

            def submit():
                idxs = next(batches, None)
                if idxs is not None:
                    pending.append([ex.submit(self.dataset.__getitem__, i)
                                    for i in idxs])
            for _ in range(PREFETCH):
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
