"""Host→device input pipeline.

Replaces the reference's TF queue-runner pipeline
(`karel_env/input_ops_karel.py:24-125`: string_input_producer → py_func →
shuffle_batch with 16 threads) with a thread-pool prefetcher that assembles
numpy batches ahead of the training step. Unlike the reference — which
dequeues each batch to host and re-feeds it through placeholders
(`trainer.py:189-199`, doubling the host↔device traffic) — batches here are
transferred once, directly to their final (possibly sharded) device layout.
"""

import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np


class BatchPipeline:
    """Iterates dict batches over a KarelDataset.

    shuffle=True -> epoch-reshuffled infinite stream (training);
    shuffle=False -> sequential epochs (eval), dropping the ragged tail like
    the reference's fixed `max_steps = len(ids) // batch_size`
    (`evaler.py:448-449`).
    """

    def __init__(self, dataset, batch_size, shuffle=True, seed=0,
                 num_threads=4, prefetch=4, sharding=None, drop_keys=(),
                 compact=False):
        self.dataset = dataset
        self.batch_size = batch_size
        if batch_size > len(dataset.ids):
            # with shuffle=True the id iterator would otherwise spin forever
            # yielding no full batch (observed as a silent trainer hang on a
            # tiny test split)
            raise ValueError(
                f"batch_size {batch_size} exceeds dataset size "
                f"{len(dataset.ids)} ({getattr(dataset, 'name', '?')})")
        self.shuffle = shuffle
        self.rng = np.random.RandomState(seed)
        self.sharding = sharding
        self.drop_keys = frozenset(drop_keys)
        # compact wire format: ship token ids + initial states only and
        # rebuild full tensors on device (ops/reconstruct.py)
        self._compact = compact
        self._pool = ThreadPoolExecutor(max_workers=num_threads)
        self._prefetch = prefetch
        self._queue = deque()
        self._id_iter = self._make_id_iter()
        self._lock = threading.Lock()

    def _make_id_iter(self):
        ids = list(self.dataset.ids)
        while True:
            order = list(range(len(ids)))
            if self.shuffle:
                self.rng.shuffle(order)
            n_full = len(order) // self.batch_size
            for b in range(n_full):
                yield [ids[i] for i in
                       order[b * self.batch_size:(b + 1) * self.batch_size]]
            if not self.shuffle:
                return  # single epoch for eval

    def steps_per_epoch(self):
        return len(self.dataset) // self.batch_size

    def fast_forward(self, n):
        """Skip the next `n` batches without loading them (exact resume:
        a relaunched trainer replays the id stream past the batches the
        dead run already consumed). Prefetched-but-unconsumed futures count
        as drawn — they are discarded first."""
        with self._lock:
            while self._queue and n > 0:
                self._queue.popleft().cancel()
                n -= 1
            for _ in range(n):
                try:
                    next(self._id_iter)
                except StopIteration:
                    break

    def _load_batch(self, id_batch):
        if self._compact:
            # vectorized assembly: one fancy-index per key over the sidecar
            # compact cache — no per-item python work
            batch = {k: v for k, v in
                     self.dataset.get_batch_compact(id_batch).items()
                     if k not in self.drop_keys}
            return self._ship(batch)
        # items are loaded SERIALLY within a batch: store reads serialize
        # on the file, so per-item thread fan-out only adds GIL contention.
        # Parallelism comes from multiple batches in flight (the executor)
        # + in-memory dataset preloading.
        items = [self.dataset.get_data(i) for i in id_batch]
        batch = {}
        for key in items[0]:
            if key in self.drop_keys:
                continue
            if key == "id":
                batch[key] = np.array([it[key] for it in items])
            else:
                batch[key] = np.stack([it[key] for it in items], axis=0)
        return self._ship(batch)

    def _ship(self, batch):
        if self.sharding is not None:
            # transfer inside the prefetch worker so host->device copies
            # overlap the training step instead of blocking it; ONE pytree
            # device_put (not per-key) — each call pays a dispatch
            import jax
            tensors = {k: v for k, v in batch.items() if k != "id"}
            shipped = jax.device_put(tensors, self.sharding)
            if "id" in batch:
                shipped["id"] = batch["id"]
            return shipped
        return batch

    def _ensure_prefetch(self):
        with self._lock:
            while len(self._queue) < self._prefetch:
                try:
                    id_batch = next(self._id_iter)
                except StopIteration:
                    break
                self._queue.append(
                    self._pool.submit(self._load_batch, id_batch))

    def __iter__(self):
        return self

    def __next__(self):
        self._ensure_prefetch()
        if not self._queue:
            raise StopIteration
        batch = self._queue.popleft().result()
        self._ensure_prefetch()
        return batch
