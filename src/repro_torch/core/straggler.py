"""Straggler detection & mitigation — the paper's `f` tracker as fleet health
(copy of ``repro/core/straggler.py``).

A tier whose EWMA throughput drifts below ``beta ×`` the median of its class
is a *straggler*: its chunks shrink automatically (the §3.2 law divides by a
smaller f), and after ``patience`` consecutive flags the tier is marked for
exclusion; the batch partitioner (:mod:`repro_torch.core.partitioner`) then
gives it no more work.
"""
from __future__ import annotations

import statistics
from dataclasses import dataclass, field


@dataclass
class TierHealth:
    ewma_thr: float = 0.0
    n_obs: int = 0
    flags: int = 0
    excluded: bool = False


@dataclass
class StragglerMonitor:
    beta: float = 0.5              # straggler iff thr < beta · median(peers)
    patience: int = 3              # consecutive flags before exclusion
    alpha: float = 0.5             # EWMA
    tiers: dict[str, TierHealth] = field(default_factory=dict)

    def observe(self, tier: str, items: int, dt: float) -> None:
        h = self.tiers.setdefault(tier, TierHealth())
        thr = items / max(dt, 1e-12)
        h.ewma_thr = thr if h.n_obs == 0 else (
            self.alpha * thr + (1 - self.alpha) * h.ewma_thr)
        h.n_obs += 1
        self._update_flags()

    def _update_flags(self) -> None:
        active = {n: h for n, h in self.tiers.items()
                  if not h.excluded and h.n_obs > 0}
        if len(active) < 2:
            return
        med = statistics.median(h.ewma_thr for h in active.values())
        for h in active.values():
            if h.ewma_thr < self.beta * med:
                h.flags += 1
                if h.flags >= self.patience:
                    h.excluded = True
            else:
                h.flags = 0

    def stragglers(self) -> list[str]:
        return [n for n, h in self.tiers.items()
                if h.flags > 0 and not h.excluded]

    def excluded(self) -> list[str]:
        return [n for n, h in self.tiers.items() if h.excluded]

    def relative_speeds(self) -> dict[str, float]:
        """Current speeds, normalised to the slowest healthy tier — the f
        vector the batch partitioner consumes."""
        act = {n: h.ewma_thr for n, h in self.tiers.items()
               if not h.excluded and h.n_obs > 0}
        if not act:
            return {}
        lo = min(act.values()) or 1.0
        return {n: v / lo for n, v in act.items()}
