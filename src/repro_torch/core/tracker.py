"""Per-resource throughput tracking → the paper's online `f` factor (copy of
``repro/core/tracker.py``).

Stage S2 of the HBB pipeline records (chunk_size, service_time) for every
completed chunk; `f` is the EWMA throughput of the accelerator class divided
by the mean EWMA throughput of the CPU-core class (§3.1: "this time is used
to update the relative speed of the FC w.r.t. a CC").
"""
from __future__ import annotations

import threading
from dataclasses import dataclass


@dataclass
class ResourceStats:
    kind: str                      # "accelerator" | "core"
    ewma_thr: float = 0.0          # iterations / second
    n_chunks: int = 0
    iters_done: int = 0
    busy_time: float = 0.0

    def record(self, chunk: int, dt: float, alpha: float) -> None:
        thr = chunk / max(dt, 1e-12)
        self.ewma_thr = thr if self.n_chunks == 0 else (
            alpha * thr + (1 - alpha) * self.ewma_thr)
        self.n_chunks += 1
        self.iters_done += chunk
        self.busy_time += dt


class ThroughputTracker:
    """Thread-safe f-factor tracker shared by the dispatch pipeline."""

    def __init__(self, resources: dict[str, str], f0: float = 8.0,
                 alpha: float = 0.5):
        self.stats = {n: ResourceStats(kind=k) for n, k in resources.items()}
        self._f0 = f0
        self._alpha = alpha
        self._lock = threading.Lock()

    def record(self, name: str, chunk: int, dt: float) -> None:
        with self._lock:
            self.stats[name].record(chunk, dt, self._alpha)

    def f(self) -> float:
        """Relative accelerator speed; falls back to the prior until both
        classes have at least one measurement."""
        with self._lock:
            acc = [s.ewma_thr for s in self.stats.values()
                   if s.kind == "accelerator" and s.n_chunks]
            cor = [s.ewma_thr for s in self.stats.values()
                   if s.kind == "core" and s.n_chunks]
            if not acc or not cor or min(cor) <= 0:
                return self._f0
            return max(1e-3, (sum(acc) / len(acc)) / (sum(cor) / len(cor)))

    def throughput(self, name: str) -> float:
        with self._lock:
            return self.stats[name].ewma_thr

    def snapshot(self) -> dict[str, ResourceStats]:
        with self._lock:
            return {n: ResourceStats(s.kind, s.ewma_thr, s.n_chunks,
                                     s.iters_done, s.busy_time)
                    for n, s in self.stats.items()}
