"""Failure injection for the fault-tolerant loop (``FailureInjector`` of
``repro/train/elastic.py``). The elastic re-mesh (``build_mesh``,
``shrink_mesh``, ``reshard_state``) waits for the multi-GPU port.
"""
from __future__ import annotations


class FailureInjector:
    """Deterministic failure schedule for fault-tolerance tests:
    {step: exception}. Each scheduled failure fires once."""

    def __init__(self, schedule: dict[int, Exception]):
        self.schedule = dict(schedule)
        self.fired: list[int] = []

    def maybe_fail(self, step: int) -> None:
        if step in self.schedule and step not in self.fired:
            self.fired.append(step)
            raise self.schedule[step]

