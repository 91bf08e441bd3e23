"""Host data loader with background prefetch (``repro/data/loader.py``).

A worker thread takes numpy batches from ``source`` and moves them to the
device: into pinned host buffers, then by non-blocking copies on the
current stream (the consumer's work queues behind them). A small queue
overlaps host data generation with device compute. Per-process shards of
the batch (``shard_index``/``num_shards``) wait for the multi-GPU port.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np
import torch

from repro_torch._device import resolve_device

_END = object()


class PrefetchLoader:
    def __init__(self, source: Iterator[dict], device=None,
                 prefetch: int = 2):
        self.source = source
        self.device = resolve_device(device)
        self.q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._error: BaseException | None = None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._work, daemon=True)
        self._thread.start()

    def _place(self, batch: dict) -> dict:
        out = {}
        for k, v in batch.items():
            t = torch.from_numpy(np.ascontiguousarray(v))
            if self.device.type == "cuda":
                t = t.pin_memory().to(self.device, non_blocking=True)
            out[k] = t
        return out

    def _work(self) -> None:
        try:
            for batch in self.source:
                if self._stop.is_set():
                    return
                self.q.put(self._place(batch))
        except Exception as e:          # handed to the consumer
            self._error = e
        finally:
            self.q.put(_END)

    def __iter__(self):
        return self

    def __next__(self):
        item = self.q.get()
        if item is _END:
            self.q.put(_END)            # later calls end too
            if self._error is not None:
                raise self._error
            raise StopIteration
        return item

    def close(self) -> None:
        """Stop the worker; drains the queue so a blocked put returns."""
        self._stop.set()
        while self._thread.is_alive():
            try:
                self.q.get(timeout=0.1)
            except queue.Empty:
                pass
        self._thread.join()
