"""Heterogeneous global-batch partitioner (``repro/core/partitioner.py``).

Training analogue of HBB's ``parallel_for``: the iteration space is the
global batch; resources are *device tiers* (groups of devices of unequal
measured throughput). Each step the batch splits per the equal-service-time
operand of the paper's law (``n_t ∝ f_t``, quantised to each tier's batch
quantum); per-step times feed the StragglerMonitor, whose updated f vector
re-partitions the next step — the paper's online `f` loop at fleet scale.

Gradients are combined with sample-count weights, so the update is
identical to an even split. Batches and gradients are parameter trees
(``params.tree_map``) of tensors or numpy arrays.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable

import torch

from repro_torch.core.chunking import proportional_split
from repro_torch.core.straggler import StragglerMonitor
from repro_torch.params import tree_leaves, tree_map


@dataclass
class Tier:
    """A homogeneous group of devices acting as one HBB resource."""
    name: str
    devices: list[Any]
    grad_fn: Callable[..., Any]       # (params, batch_slice) → (grads, metrics)
    slowdown: float = 1.0             # test hook: simulated degradation


def _wait(tree) -> None:
    """Block until every tensor of ``tree`` on the card is computed (a
    ``torch.cuda.synchronize`` of each device it lies on); host tensors and
    arrays are ready already."""
    for d in {t.device for t in tree_leaves(tree)
              if isinstance(t, torch.Tensor) and t.is_cuda}:
        torch.cuda.synchronize(d)


@dataclass
class HeterogeneousBatchPartitioner:
    tiers: list[Tier]
    quantum: int = 1                  # per-tier batch must be a multiple
    monitor: StragglerMonitor = field(default_factory=StragglerMonitor)
    warmup_obs: int = 1               # skip first N timings per tier (first
    _seen: dict = field(default_factory=dict)  # calls would skew f)

    def split(self, global_batch: int) -> list[int]:
        excluded = self.monitor.excluded()
        speeds = self.monitor.relative_speeds()
        names = [t.name for t in self.tiers if t.name not in excluded]
        spd = [max(speeds.get(n, 1.0), 1e-3) for n in names]
        parts = proportional_split(global_batch, spd, self.quantum)
        return [parts[names.index(t.name)] if t.name in names else 0
                for t in self.tiers]

    def step(self, params, batch) -> tuple[Any, dict]:
        """batch: a tree with leading dim = global_batch. Runs each tier on
        its slice, records service times, returns weighted-mean grads."""
        gb = len(tree_leaves(batch)[0])
        parts = self.split(gb)
        grads, counts = [], []
        offset = 0
        for t, n in zip(self.tiers, parts):
            if n == 0:
                continue
            sl = tree_map(lambda x, o=offset, n=n: x[o:o + n], batch)
            offset += n
            t0 = time.perf_counter()
            g, _ = t.grad_fn(params, sl)
            _wait(g)
            dt = time.perf_counter() - t0
            if t.slowdown > 1.0:
                time.sleep(dt * (t.slowdown - 1.0))
                dt *= t.slowdown
            self._seen[t.name] = self._seen.get(t.name, 0) + 1
            if self._seen[t.name] > self.warmup_obs:
                self.monitor.observe(t.name, n, dt)
            grads.append(g)
            counts.append(n)
        total = sum(counts)
        weights = [c / total for c in counts]
        flat = [tree_leaves(g) for g in grads]
        means = iter([sum(w * leaves[i] for w, leaves in zip(weights, flat))
                      for i in range(len(flat[0]))])
        mean = tree_map(lambda _: next(means), grads[0])
        info = {"parts": parts,
                "speeds": self.monitor.relative_speeds(),
                "stragglers": self.monitor.stragglers(),
                "excluded": self.monitor.excluded()}
        return mean, info
