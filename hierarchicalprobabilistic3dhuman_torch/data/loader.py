"""Minimal threaded data loader (torch-free).

Replaces torch.utils.data.DataLoader(num_workers=2, pin_memory=True) in the
reference: a Dataset here is any object with __len__/__getitem__ returning a
dict of numpy arrays (+ scalar strings); the loader stacks them into batches
and prefetches with a thread pool so host I/O overlaps device compute.
"""

import queue
import threading

import numpy as np


def _collate(items):
    batch = {}
    for key in items[0]:
        vals = [it[key] for it in items]
        if isinstance(vals[0], np.ndarray):
            batch[key] = np.stack(vals)
        elif isinstance(vals[0], (int, float, np.floating, np.integer)):
            batch[key] = np.asarray(vals)
        else:
            batch[key] = vals  # strings etc.
    return batch


class DataLoader:
    def __init__(self, dataset, batch_size=1, shuffle=False, drop_last=False,
                 num_workers=2, prefetch=4, seed=0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = max(num_workers, 0)
        self.prefetch = prefetch
        self._rng = np.random.RandomState(seed)

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _batch_indices(self):
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            self._rng.shuffle(idx)
        end = (len(idx) // self.batch_size * self.batch_size
               if self.drop_last else len(idx))
        for s in range(0, end, self.batch_size):
            yield idx[s:s + self.batch_size]

    def __iter__(self):
        if self.num_workers == 0:
            for indices in self._batch_indices():
                yield _collate([self.dataset[int(i)] for i in indices])
            return

        q = queue.Queue(maxsize=self.prefetch)
        batches = list(self._batch_indices())
        stop = object()

        def worker():
            try:
                for indices in batches:
                    q.put(_collate([self.dataset[int(i)] for i in indices]))
            finally:
                q.put(stop)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is stop:
                break
            yield item
        t.join()
