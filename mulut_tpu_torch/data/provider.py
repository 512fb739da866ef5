"""Host-side prefetching batch provider.

Replaces the reference's multi-process torch DataLoader + `.cuda()` transfer
(ref: sr/data.py:13-49) with a thread pool that assembles NumPy batches ahead
of the training loop; the training step itself owns the host->device transfer
(the port's twin of `mulut_tpu.data.provider`).  Threads, not processes:
batch assembly is NumPy slicing, which releases the GIL enough, and the
arrays go straight to the card without pickling.  With one worker the
batches come in the order one `DIV2K(seed=seed * 1000)` draws them.
"""

from __future__ import annotations

import queue
import threading

from .div2k import DIV2K


class Provider:
    """Infinite prefetching iterator of (im, lb) NumPy batch pairs."""

    def __init__(self, batch_size: int, num_workers: int, scale: int,
                 path: str, patch_size: int, prefetch: int = 8, seed: int = 0):
        self.batch_size = batch_size
        self.queue: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._failure: Exception | None = None
        self.iteration = 0
        self._workers = []
        num_workers = max(1, num_workers)
        for w in range(num_workers):
            ds = DIV2K(scale, path, patch_size, seed=seed * 1000 + w)
            t = threading.Thread(target=self._worker, args=(ds,), daemon=True)
            t.start()
            self._workers.append(t)

    def _worker(self, ds: DIV2K) -> None:
        while not self._stop.is_set():
            try:
                batch = ds.sample_batch(self.batch_size)
            except Exception as e:  # noqa: BLE001
                # Propagate to the consumer: a silently-dead worker would
                # leave next() blocked forever.  The put MUST be retried —
                # dropping it when the queue happens to be full re-creates
                # the deadlock once the consumer drains the stale batches.
                while not self._stop.is_set():
                    try:
                        self.queue.put(e, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                return
            try:
                self.queue.put(batch, timeout=1.0)
            except queue.Full:
                continue

    def next(self):
        if self._failure is not None:
            raise RuntimeError("data worker failed") from self._failure
        self.iteration += 1
        item = self.queue.get()
        if isinstance(item, Exception):
            self._failure = item
            raise RuntimeError("data worker failed") from item
        return item

    def close(self) -> None:
        self._stop.set()
