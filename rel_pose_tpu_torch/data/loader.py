"""Threaded prefetching data loader (host-side, framework-free).

A copy of ``rel_pose_tpu/data/loader.py``: the same seed, epoch and shards
give the same batches in the same order.  It replaces the reference's torch
``DataLoader`` + ``DistributedSampler`` (``train.py:127-132``):

  * deterministic per-epoch shuffling from a seed (DistributedSampler
    semantics: every replica derives the same permutation, then takes a
    strided slice);
  * sharding by ``num_shards`` / ``shard_index`` (one shard per process of
    a data-parallel run);
  * a pool of decode workers (cv2 releases the GIL, so threads parallelize
    JPEG/PNG decode well) feeding a bounded prefetch queue;
  * batches are delivered as stacked numpy arrays; the training CLI pins
    them and copies them to the card asynchronously, one batch ahead.
"""

import os
import queue
import threading

import numpy as np


class DataLoader:
    def __init__(self, dataset, batch_size, shuffle=True, seed=0, epoch=0,
                 num_workers=4, num_shards=1, shard_index=0, drop_last=True,
                 prefetch=4):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = epoch
        self.num_workers = max(1, num_workers)
        self.num_shards = num_shards
        self.shard_index = shard_index
        self.drop_last = drop_last
        self.prefetch = prefetch

    def _apply_thread_budget(self):
        # divide the host's cores among the workers' native pipeline calls:
        # N workers each spawning the library default min(ncpu, 16) threads
        # oversubscribe the host (measured: 8 workers SLOWER than 1).  The
        # budget is process-global, so it is applied when iteration STARTS
        # (not at construction) — the loader actually consuming the host
        # owns the budget; merely constructing a val loader must not
        # re-budget a running train loader.
        from .. import native
        share = max(1, (os.cpu_count() or 4) // self.num_workers)
        native.set_num_threads(share)
        try:  # cv2's internal parallel_for has the same oversubscription
            import cv2
            # single worker: negative value restores cv2's own default
            # thread pool (0 would DISABLE cv2 threading entirely)
            cv2.setNumThreads(share if self.num_workers > 1 else -1)
        except Exception:
            pass

    def _indices(self):
        n = len(self.dataset)
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            order = rng.permutation(n)
        else:
            order = np.arange(n)
        # DistributedSampler-style padding so every shard sees the same
        # number of samples
        if self.num_shards > 1:
            total = -(-n // self.num_shards) * self.num_shards
            if total > n:
                order = np.concatenate([order, order[: total - n]])
            order = order[self.shard_index:: self.num_shards]
        return order

    def __len__(self):
        per_shard = len(self._indices())
        if self.drop_last:
            return per_shard // self.batch_size
        return -(-per_shard // self.batch_size)

    def __iter__(self):
        self._apply_thread_budget()
        order = self._indices()
        nb = len(self)
        batches = [order[i * self.batch_size:(i + 1) * self.batch_size]
                   for i in range(nb)]

        out_q = queue.Queue(maxsize=self.prefetch)
        lock = threading.Lock()
        next_emit = [0]
        work_iter = iter(enumerate(batches))
        stop = threading.Event()

        def worker():
            while not stop.is_set():
                with lock:
                    try:
                        bi, idxs = next(work_iter)
                    except StopIteration:
                        return
                try:
                    samples = [self.dataset[int(i)] for i in idxs]
                    batch = tuple(np.stack([s[f] for s in samples])
                                  for f in range(len(samples[0])))
                except Exception as e:  # surface errors to the consumer
                    batch = e
                # in-order delivery
                while not stop.is_set():
                    with lock:
                        if next_emit[0] == bi:
                            break
                    stop.wait(0.002)
                if stop.is_set():
                    return
                # bounded put that still honors shutdown (a blocked put on a
                # full queue must not outlive an early-exiting consumer)
                while not stop.is_set():
                    try:
                        out_q.put((bi, batch), timeout=0.1)
                        break
                    except queue.Full:
                        continue
                else:
                    return
                with lock:
                    next_emit[0] += 1

        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(self.num_workers)]
        for t in threads:
            t.start()
        try:
            for _ in range(nb):
                bi, batch = out_q.get()
                if isinstance(batch, Exception):
                    raise batch
                yield batch
        finally:
            stop.set()
            for t in threads:
                t.join(timeout=1.0)
