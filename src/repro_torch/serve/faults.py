"""Deterministic fault injection for the serving pool
(``repro/serve/faults.py``, whole; DESIGN.md §8).

A serving pool that claims to survive sick tiers needs every failure path
exercised in tier-1 — which means faults must be *injectable on a
reproducible schedule*, not waited for. :class:`FaultyEngine` wraps an
:class:`~repro_torch.serve.engine.Engine` behind the exact tier-facing surface
``MultiEngine`` drives (``step`` / ``plan_admission`` / ``take_pending`` /
``has_work`` / ``drain`` / ``abort`` / ``submit``) and injects the fault
taxonomy on a seeded schedule:

=============  ==========================================================
kind           what the supervisor sees
=============  ==========================================================
``"raise"``    ``step()`` raises :class:`InjectedFault` *before* touching
               the wrapped engine — the quantum is lost, engine state
               stays coherent (a device reset / kernel abort).
``"hang"``     ``step()`` sleeps ``hang_s`` first, then runs the real
               quantum — wall time blows the tier's step deadline but the
               work lands (a wedged interconnect / preempted VM). Tokens
               emitted during a hung step are kept: the resume law
               continues from them.
``"exhaust"``  ``plan_admission()`` reports 0 capacity for the scheduled
               cycles (transient pool pressure). NOT a failure — the
               router's existing work-conservation reroutes around it and
               tier health must stay ``healthy``.
``"nan"``      ``step()`` skips the quantum and returns a corrupt
               :class:`~repro_torch.serve.engine.StepReport` (NaN ``dt``,
               absurd ``decoded``) — silent device corruption. The
               supervisor must reject the report (never feed it to the
               throughput tracker) and count a failure.
=============  ==========================================================

Schedules are deterministic by construction: explicit step indices
(``at``), a periodic window, or a seeded Bernoulli draw per step — the
draw sequence depends only on ``seed`` (numpy's ``default_rng``, as the
JAX package draws it, so one ``Fault`` fires at the same steps in both),
and a failing scenario replays bit-identically from its parameters.
Everything here is host-side bookkeeping.
"""
from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np

from repro_torch.serve.engine import Engine, Request, StepReport

FAULT_KINDS = ("raise", "hang", "exhaust", "nan")


class InjectedFault(RuntimeError):
    """The step exception :class:`FaultyEngine` raises on a scheduled
    ``"raise"`` fault. A distinct type so tests can assert the supervisor
    survived *this* injection rather than some incidental error."""


@dataclass(frozen=True)
class Fault:
    """One deterministic fault line of a :class:`FaultyEngine` schedule.

    A fault *triggers* at engine-local step index ``i`` when ``i`` is in
    ``at``, or when ``every > 0`` and ``i % every == phase``, or when the
    seeded Bernoulli draw for step ``i`` is below ``p``. A trigger at
    ``i`` keeps the fault active for steps ``[i, i + n)`` — ``n > 1``
    models a tier that stays sick for several quanta (what drives
    degraded → quarantined: *consecutive* failures).

    Attributes:
      kind: one of :data:`FAULT_KINDS`.
      at: explicit trigger step indices.
      every: periodic trigger period (0: off).
      phase: offset of the periodic trigger.
      p: per-step trigger probability, drawn from ``seed`` (0: off).
      seed: RNG seed for the Bernoulli schedule; same seed → same
        schedule, independent of wall clock or call pattern.
      n: consecutive steps a trigger stays active.
      hang_s: sleep injected per hung step (``kind="hang"`` only).
    """
    kind: str
    at: tuple[int, ...] = ()
    every: int = 0
    phase: int = 0
    p: float = 0.0
    seed: int = 0
    n: int = 1
    hang_s: float = 0.05

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"fault kind must be one of {FAULT_KINDS}, "
                             f"got {self.kind!r}")
        if self.n < 1:
            raise ValueError(f"fault n must be >= 1, got {self.n}")
        if not 0.0 <= self.p <= 1.0:
            raise ValueError(f"fault p must be in [0, 1], got {self.p}")

    def schedule(self, horizon: int) -> list[bool]:
        """Active mask for steps ``[0, horizon)`` — the reproducibility
        contract: a pure function of the Fault's fields."""
        rng = np.random.default_rng(self.seed)
        trig = [False] * horizon
        for i in range(horizon):
            draw = rng.random()            # always advance: index-stable
            if (i in self.at
                    or (self.every > 0 and i % self.every == self.phase)
                    or (self.p > 0 and draw < self.p)):
                trig[i] = True
        active = [False] * horizon
        for i, t in enumerate(trig):
            if t:
                for j in range(i, min(i + self.n, horizon)):
                    active[j] = True
        return active


class FaultyEngine:
    """An :class:`~repro_torch.serve.engine.Engine` that fails on schedule.

    Presents the same tier-facing surface as the engine it wraps, so a
    ``MultiEngine`` tier (or a bare caller) cannot tell it apart until a
    fault fires. ``step``-shaped faults key off the wrapper's own step
    counter; ``exhaust`` keys off the *admission-probe* counter
    (``plan_admission`` calls), since that is the call the router gates
    capacity on. All other attribute access passes through, so routing
    diagnostics, page allocators and guard limits see the real engine.

    ``fault_log`` records ``(counter, kind)`` per injection for tests and
    the bench to assert the schedule fired as planned.
    """

    def __init__(self, engine: Engine, faults: list[Fault], *,
                 horizon: int = 4096):
        for f in faults:
            if not isinstance(f, Fault):
                raise ValueError(f"faults must be Fault instances, "
                                 f"got {type(f).__name__}")
        self.engine = engine
        self.faults = list(faults)
        self.horizon = horizon
        self._active = [(f, f.schedule(horizon)) for f in faults]
        self.steps_seen = 0
        self.probes_seen = 0
        self.fault_log: list[tuple[int, str]] = []

    def _firing(self, kind: str, idx: int) -> Fault | None:
        for f, mask in self._active:
            if f.kind == kind and idx < self.horizon and mask[idx]:
                return f
        return None

    # ---- tier-facing surface (same contract as Engine) -------------------
    def step(self) -> StepReport:
        """One engine cycle, possibly sabotaged: ``raise`` loses the
        quantum, ``hang`` delays it past any deadline, ``nan`` replaces
        its report with garbage. The wrapped engine's own state is only
        ever advanced by *real* steps, so recovery tests measure the
        supervisor, not wrapper corruption."""
        idx = self.steps_seen
        self.steps_seen += 1
        if self._firing("raise", idx):
            self.fault_log.append((idx, "raise"))
            raise InjectedFault(f"injected step failure at step {idx}")
        if self._firing("nan", idx):
            self.fault_log.append((idx, "nan"))
            # quantum discarded: a corrupt report means the device's output
            # cannot be trusted, so nothing must reach request streams
            return StepReport(admitted=0, decoded=1 << 30, dt=float("nan"),
                              warm=True)
        f = self._firing("hang", idx)
        if f is not None:
            self.fault_log.append((idx, "hang"))
            time.sleep(f.hang_s)
        return self.engine.step()

    def plan_admission(self, reqs: list[Request]) -> int:
        """Admission probe; an active ``exhaust`` fault reports zero
        capacity (transient pool pressure) without touching health."""
        idx = self.probes_seen
        self.probes_seen += 1
        if self._firing("exhaust", idx):
            self.fault_log.append((idx, "exhaust"))
            return 0
        return self.engine.plan_admission(reqs)

    def submit(self, req: Request) -> None:
        self.engine.submit(req)

    def take_pending(self) -> list[Request]:
        return self.engine.take_pending()

    def has_work(self) -> bool:
        return self.engine.has_work()

    def drain(self) -> None:
        # loop the wrapper's own step so scheduled faults fire during a
        # drain too (Engine.drain would call the real step and bypass them)
        while self.has_work():
            self.step()

    def abort(self) -> list[Request]:
        return self.engine.abort()

    def __getattr__(self, name):
        # everything not faulted (free_slots, pending, slot_req, max_len,
        # alloc, paged, decode_quantum, stream, …) is the real engine's
        return getattr(self.engine, name)
