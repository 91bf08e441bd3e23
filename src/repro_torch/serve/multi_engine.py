"""Multi-engine heterogeneous serving — the paper's CC/FC pool at request
granularity (``repro/serve/multi_engine.py``).

The paper's core result (§6) is that a dynamic scheduler distributing one
workload across *all* device classes — CPU cores assisting the FPGA —
beats pure offload. :class:`MultiEngine` is that scheduler at serving
granularity: it owns N heterogeneous
:class:`~repro_torch.serve.engine.Engine` tiers (e.g. a short-context dense
tier and a long-context paged tier) under ONE shared
:class:`~repro_torch.core.tracker.ThroughputTracker`, and routes submitted
requests across them with the same ``proportional_split`` law the HBB
static/oracle schedulers use — per-tier *measured* tok/s over token-unit
cost (:mod:`repro_torch.serve.scheduler`).

Mapping onto the paper's two-stage pipeline (Fig. 1):

* **S1 (dispatch)** — each global cycle, the queued requests are split
  over the tiers in proportion to their effective speeds, capped by each
  tier's admission capacity (free slots; paged tiers additionally their
  pool's worst-case commit budget via ``Engine.plan_admission``).
* **S2 (accounting)** — each tier's
  :class:`~repro_torch.serve.engine.StepReport` feeds ``(decoded tokens,
  quantum seconds)`` of warm cycles (no graph captured) into the shared
  tracker, which is what the next S1 round measures speeds from.

Work conservation: a tier that stalls or whose pool exhausts simply has no
capacity, so its share spills to the live tiers; whatever a tier's own
admission law could not take this cycle is reclaimed (``take_pending``)
into the global queue and rerouted next cycle. Queued work is never
blocked behind a dead tier.

Tiers with ``concurrent=True`` (default) step in parallel threads — the
serving analogue of the paper's resources running simultaneously; each
engine is only ever touched by one thread per cycle, engines share the
(read-only) parameter tree, and the shared tracker is lock-guarded. On
the card each engine enqueues on its own CUDA stream, so the tiers' work
overlaps on one card; a graph capture forbids unsafe calls only in its own
thread, and the kernels' launch counts stay exact across threads
(``serve/graphs.py``). At ``temperature=0`` every tier built over the same
parameters decodes the same greedy stream, so a request's output is
independent of the tier that served it (``tests/test_torch_multi_engine.
py``).

``StepReport.decoded`` counts *emitted* tokens, so a speculative tier
(an ``Engine`` with a draft) is measured at its effective tok/s, never at
proposals; its ``accepted``/``proposed`` tallies and their ratio are
surfaced through :meth:`MultiEngine.stats`.

Fault tolerance (DESIGN.md §8): the pool survives a *sick* tier the same
way it survives a slow one. A per-tier health state machine (healthy →
degraded → quarantined → probation, :class:`HealthPolicy`) is driven by
step failures — exceptions, corrupt :class:`StepReport`s, and a per-step
deadline watchdog (``future`` timeouts in concurrent mode, post-hoc wall
time in serial). Quarantining a tier reclaims its in-flight requests
(``take_pending`` + failure-safe ``Engine.abort``, pages released) and
re-routes them the same cycle through the ordinary scheduler law with the
sick tier's capacity masked to zero (:func:`repro_torch.serve.scheduler.
apply_health`); each reclaimed request re-prefills from its original
prompt plus already-emitted tokens (:func:`repro_torch.serve.decode.
plan_resume`), so greedy recovery streams are token-identical to an
unfailed run. Retries are budgeted with exponential backoff; a request
that exhausts its budget is dead-lettered
(:class:`~repro_torch.serve.engine.RequestFailedError` in
``dead_letters``)
instead of poisoning the pool. After its hold, a quarantined tier
re-enters through probation: one canary request until
``probation_steps`` clean steps restore its full share. A tier that
recovers keeps its captured graphs: ``Engine.abort`` zeroes the slot state
in place and rebinds nothing a quantum reads.
"""
from __future__ import annotations

import math
import time
from concurrent.futures import ThreadPoolExecutor
from concurrent.futures import TimeoutError as FuturesTimeout
from dataclasses import dataclass, field
from typing import Optional

from repro_torch.configs.base import ModelConfig
from repro_torch.core.tracker import ThroughputTracker
from repro_torch.params import init_params
from repro_torch.serve.decode import plan_resume
from repro_torch.serve.engine import (Engine, EngineStallError,
                                      PromptTooLongError, Request,
                                      RequestFailedError, StepReport)
from repro_torch.serve.scheduler import (DEGRADED, HEALTHY, PROBATION,
                                         QUARANTINED, apply_health,
                                         request_units, route_requests,
                                         tier_speeds)


@dataclass(frozen=True)
class HealthPolicy:
    """Knobs of the tier health supervisor and request retry law (§8).

    Attributes:
      quarantine_after: consecutive step failures that quarantine a tier.
        The first failure already marks it ``degraded`` (bookkeeping
        only — routing is unchanged, one transient fault must not shed
        load).
      quarantine_cycles: pool cycles a quarantined tier sits out before
        probation. Doubled (capped at 64) each time its probation canary
        fails — exponential backoff for a tier that keeps relapsing.
      probation_steps: clean steps a probation tier must serve (on its
        single canary request) before its full routing share is restored.
      retry_budget: failed attempts per *request* before it is
        dead-lettered with
        :class:`~repro_torch.serve.engine.RequestFailedError` instead of
        retried again.
      retry_backoff: base pool-cycle delay before a failed request
        re-enters the queue; attempt ``k`` waits
        ``retry_backoff · 2^(k−1)`` cycles.
      step_deadline_s: pool-default per-step wall-clock deadline (None:
        none). A tier's own ``Engine.step_deadline_s`` takes precedence.
        In concurrent mode the watchdog times out the step's future; in
        serial mode the check is post-hoc (the step cannot be preempted,
        but a hung quantum still counts as a failure).
    """
    quarantine_after: int = 2
    quarantine_cycles: int = 2
    probation_steps: int = 2
    retry_budget: int = 3
    retry_backoff: int = 1
    step_deadline_s: float | None = None

    def __post_init__(self):
        if (self.quarantine_after < 1 or self.quarantine_cycles < 1
                or self.probation_steps < 1 or self.retry_budget < 0
                or self.retry_backoff < 0):
            raise ValueError(f"invalid HealthPolicy: {self}")
        if self.step_deadline_s is not None and self.step_deadline_s <= 0:
            raise ValueError("step_deadline_s must be positive or None, "
                             f"got {self.step_deadline_s}")


@dataclass
class EngineTier:
    """One resource of the serving pool: an engine plus its routing traits.

    Attributes:
      name: unique tier label (tracker resource name, routing logs).
      engine: the :class:`~repro_torch.serve.engine.Engine` serving this
        tier.
      kind: tracker classification, ``"accelerator"`` or ``"core"`` —
        the paper's FC vs CC device classes (reporting only; routing uses
        measured speeds, not the class).
      unit_cost: relative cost of one token on this tier (energy, $/hour,
        contention). Routing divides measured tok/s by it, so a tier twice
        as expensive earns half the share its raw speed would.
      prior_tok_s: routing speed assumed until the shared tracker has a
        warm measurement for this tier (the ``f0`` analogue).
      health: supervisor state (scheduler.HEALTHY/DEGRADED/QUARANTINED/
        PROBATION); transitions are appended to ``MultiEngine.health_log``.
    """
    name: str
    engine: Engine
    kind: str = "core"
    unit_cost: float = 1.0
    prior_tok_s: float = 1.0
    routed: int = field(default=0, init=False)      # requests sent here
    decoded: int = field(default=0, init=False)     # tokens emitted here
    accepted: int = field(default=0, init=False)    # spec: draft tokens kept
    proposed: int = field(default=0, init=False)    # spec: draft tokens tried
    # ---- supervisor state (§8) -------------------------------------------
    health: str = field(default=HEALTHY, init=False)
    fail_streak: int = field(default=0, init=False)  # consecutive failures
    failures: int = field(default=0, init=False)     # lifetime failures
    reclaims: int = field(default=0, init=False)     # requests pulled back
    quarantined_at: int = field(default=-1, init=False)
    quarantine_len: int = field(default=0, init=False)
    probation_ok: int = field(default=0, init=False)
    # a step future that blew its deadline and is still running; the
    # engine is untouchable (its thread owns it) until the future is done
    inflight: Optional[object] = field(default=None, init=False)
    reclaimed: bool = field(default=True, init=False)


class MultiEngine:
    """N heterogeneous Engine tiers behind one submit/step/run surface.

    See the module docstring for the scheduling model. Construction
    validates the pool: at least one tier, unique names, distinct engine
    objects (an engine updates its cache in place — sharing one between
    tiers would alias its buffers).
    """

    def __init__(self, tiers: list[EngineTier], *, concurrent: bool = True,
                 policy: HealthPolicy | None = None):
        if not tiers:
            raise ValueError("MultiEngine needs at least one tier")
        names = [t.name for t in tiers]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate tier names: {names}")
        engines = [t.engine for t in tiers]
        if len({id(e) for e in engines}) != len(engines):
            raise ValueError("tiers must not share an Engine object (its "
                             "decode quantum updates the cache in place)")
        for t in tiers:
            if t.kind not in ("accelerator", "core"):
                raise ValueError(f"tier {t.name}: kind must be "
                                 f"'accelerator' or 'core', got {t.kind!r}")
            if t.unit_cost <= 0 or t.prior_tok_s <= 0:
                raise ValueError(f"tier {t.name}: unit_cost and prior_tok_s "
                                 "must be positive")
        self.tiers = list(tiers)
        self.tracker = ThroughputTracker({t.name: t.kind for t in tiers})
        self.queue: list[Request] = []
        # rid → tier name, written at routing time. Reporting surface (the
        # bench and tests read it after run()); entries persist for the
        # pool's lifetime — a long-lived caller that recycles rids can
        # clear it between batches.
        self.assigned: dict[int, str] = {}
        self.cycle_log: list[dict] = []
        self.cycles = 0
        self._pool = (ThreadPoolExecutor(max_workers=len(tiers),
                                         thread_name_prefix="tier")
                      if concurrent and len(tiers) > 1 else None)
        # ---- fault tolerance (§8) ----------------------------------------
        self.policy = policy or HealthPolicy()
        # rid → RequestFailedError for requests that exhausted their retry
        # budget (or were orphaned by a pool stall); the pool no longer
        # tracks them, run() does not raise for them
        self.dead_letters: dict[int, RequestFailedError] = {}
        # rid → original identity of a request being retried: we mutate the
        # caller's Request in place (prompt := prompt+out, budget shrunk)
        # and restore prompt/max_new/full stream when it terminates
        self._resume: dict[int, dict] = {}
        self._delayed: list[tuple[int, Request]] = []   # (ready_cycle, req)
        self.retries = 0                                # resubmitted streams
        self.health_log: list[dict] = []                # state transitions

    # ---- submission ------------------------------------------------------
    def submit(self, req: Request) -> None:
        """Queue a request. Raises :class:`PromptTooLongError` only when NO
        tier can ever hold the prompt — a prompt too long for one tier is
        simply ineligible there and routes to a longer-context tier.

        Well-defined after a mid-run failure (§8): a Request *object*
        already queued, backing off for retry, or in flight on a tier is
        rejected with :class:`ValueError` (double-submitting it would
        alias one stream through two slots); a previously dead-lettered
        ``rid`` re-queues cleanly — the dead letter is cleared and the
        request is served fresh from its current fields. After ``run()``
        raised :class:`EngineStallError`, the pool is already reclaimed
        (no stale per-tier state), so new submissions start from a clean
        pool."""
        n = len(req.prompt)
        if n == 0:
            raise ValueError(f"request {req.rid}: empty prompt")
        if all(n >= t.engine.max_len for t in self.tiers):
            raise PromptTooLongError(
                f"request {req.rid}: prompt of {n} tokens exceeds every "
                f"tier's max_len "
                f"({[t.engine.max_len for t in self.tiers]})")
        live = any(req is r for r in self.queue)
        live = live or any(req is r for _, r in self._delayed)
        for t in self.tiers:
            live = live or any(req is r for r in t.engine.pending)
            live = live or any(req is r for r in t.engine.slot_req
                               if r is not None)
        if live:
            raise ValueError(
                f"request {req.rid} is already queued or in flight — a "
                f"Request object is single-use until it terminates")
        self.dead_letters.pop(req.rid, None)   # resubmission clears it
        self._resume.pop(req.rid, None)        # and any stale retry state
        self.queue.append(req)

    def has_work(self) -> bool:
        return (bool(self.queue) or bool(self._delayed)
                or any(t.inflight is not None for t in self.tiers)
                or any(t.engine.has_work() for t in self.tiers))

    # ---- S1: route -------------------------------------------------------
    def _route(self) -> dict[str, int]:
        """Split the global queue across tiers (proportional_split over
        measured speeds, capacity- and eligibility-capped) and push each
        tier's slice into its pending queue. Returns per-tier counts.

        A tier can refuse part of its slice (``plan_admission``: pool
        cannot commit the worst case). Refused requests mark that tier
        ineligible for the rest of this cycle and the remainder re-routes
        immediately — otherwise a pool-exhausted tier that *looks* fast to
        the proportional law would win the same request every cycle and
        starve it while other tiers idle (work conservation)."""
        routed = {t.name: 0 for t in self.tiers}
        if not self.queue:
            return routed
        speeds = tier_speeds(
            [self.tracker.throughput(t.name) for t in self.tiers],
            [t.prior_tok_s for t in self.tiers],
            [t.unit_cost for t in self.tiers])
        blocked: dict[int, set[int]] = {}       # id(req) → refusing tiers
        for _ in range(len(self.tiers)):
            queue = self.queue
            units = [request_units(len(r.prompt), r.max_new) for r in queue]
            caps = [max(0, len(t.engine.free_slots()) - len(t.engine.pending))
                    for t in self.tiers]
            # health mask (§8): quarantined tiers take nothing, probation
            # tiers at most one canary; a tier whose hung step still owns
            # its engine thread is untouchable regardless of health
            busy = [sum(1 for r in t.engine.slot_req if r is not None)
                    + len(t.engine.pending) for t in self.tiers]
            caps = apply_health(caps, [t.health for t in self.tiers], busy)
            caps = [0 if t.inflight is not None else c
                    for t, c in zip(self.tiers, caps)]
            eligible = [[len(r.prompt) < t.engine.max_len
                         and i not in blocked.get(id(r), ())
                         for i, t in enumerate(self.tiers)] for r in queue]
            assign = route_requests(units, speeds, caps, eligible)
            taken: set[int] = set()
            refused = False
            for i, (tier, idxs) in enumerate(zip(self.tiers, assign)):
                reqs = [queue[j] for j in idxs]
                try:
                    k = tier.engine.plan_admission(reqs)
                except Exception as e:           # a sick tier must not
                    self._observe_failure(tier,  # poison routing itself
                                          f"plan_admission raised: {e!r}")
                    k = 0
                for req in reqs[:k]:
                    tier.engine.submit(req)
                    self.assigned[req.rid] = tier.name
                    tier.routed += 1
                    routed[tier.name] += 1
                    taken.add(id(req))
                for req in reqs[k:]:
                    blocked.setdefault(id(req), set()).add(i)
                    refused = True
            if taken:
                self.queue = [r for r in self.queue if id(r) not in taken]
            if not refused or not self.queue:
                break
        return routed

    # ---- one global cycle ------------------------------------------------
    def step(self) -> dict[str, StepReport]:
        """One pool cycle: poll hung steps, advance health timers, release
        backed-off retries, route (S1), step every steppable tier with
        work — in parallel threads under the deadline watchdog when
        ``concurrent`` — then record *valid* warm throughput samples into
        the shared tracker (S2), apply health transitions, reclaim both
        admission leftovers and any newly quarantined tier's in-flight
        requests, and restore completed retried streams."""
        self._poll_inflight()
        self._advance_health()
        self._release_delayed()
        # arrival order of this cycle's queue: reclaimed leftovers were
        # routed from it, so this is enough to restore global FIFO after
        # they come back (requests submitted directly to a tier's engine
        # were never in the queue — they join at the tail, stably)
        order = {id(r): i for i, r in enumerate(self.queue)}
        routed = self._route()
        busy = [t for t in self.tiers
                if t.health != QUARANTINED and t.inflight is None
                and t.engine.has_work()]
        if not busy:
            # nothing steppable — if the pool is only waiting on a hung
            # step thread, block on it briefly instead of burning guard
            # cycles in a busy spin (the thread cannot be preempted; its
            # tier is reclaimed by _poll_inflight next cycle)
            for tier in self.tiers:
                if tier.inflight is not None:
                    try:
                        tier.inflight.result(timeout=0.25)
                    except Exception:
                        pass
                    break
        outcomes = self._step_tiers(busy)
        out: dict[str, StepReport] = {}
        for tier, (status, payload) in zip(busy, outcomes):
            if status in ("ok", "slow") and self._report_ok(tier, payload):
                rep = payload
                out[tier.name] = rep
                tier.decoded += rep.decoded
                tier.accepted += rep.accepted
                tier.proposed += rep.proposed
                if status == "ok":
                    # decoded counts *emissions* (for spec tiers: accepted
                    # tokens, never rounds or proposals), so the tracker's
                    # tok/s is the acceptance-scaled effective speed
                    if rep.decoded and rep.warm:
                        self.tracker.record(tier.name, rep.decoded, rep.dt)
                    self._observe_success(tier)
                else:
                    # the quantum landed (tokens are in the streams) but
                    # blew the deadline: keep the work, never the sample
                    self._observe_failure(tier, "step deadline exceeded")
            elif status in ("ok", "slow"):
                self._observe_failure(tier, "corrupt StepReport "
                                            f"({payload!r:.80})")
            elif status == "error":
                self._observe_failure(tier, f"step raised: {payload!r:.120}")
            else:                              # "timeout": thread still runs
                self._observe_failure(
                    tier, "step deadline exceeded (still running)")
            if tier.inflight is not None:
                continue                       # engine owned by its thread
            leftovers = tier.engine.take_pending()
            if leftovers:
                for req in leftovers:       # back to global, reroutable
                    # only un-count requests this router actually placed —
                    # work submitted to the engine directly just joins the
                    # global queue without touching the tier's stats
                    if self.assigned.pop(req.rid, None) is not None:
                        tier.routed -= 1
                self.queue.extend(leftovers)
        self._finish_retries()
        if self.queue:
            self.queue.sort(key=lambda r: order.get(id(r), len(order)))
        self.cycles += 1
        self.cycle_log.append({
            "queued": len(self.queue),
            "routed": routed,
            "decoded": {name: rep.decoded for name, rep in out.items()},
            "health": {t.name: t.health for t in self.tiers},
        })
        return out

    # ---- supervisor internals (§8) ---------------------------------------
    def _deadline(self, tier: EngineTier) -> float | None:
        """Effective per-step deadline: the engine's own hook wins, the
        pool policy is the default."""
        own = getattr(tier.engine, "step_deadline_s", None)
        return own if own is not None else self.policy.step_deadline_s

    def _step_tiers(self, busy: list[EngineTier]) -> list[tuple]:
        """Step every busy tier; returns (status, payload) per tier,
        parallel to ``busy``, with status "ok" (payload StepReport),
        "slow" (report, but past the deadline), "error" (exception), or
        "timeout" (concurrent only — the step future missed its deadline
        and is still running; the tier's ``inflight`` now owns the engine
        until it completes)."""
        outcomes: list[tuple] = []
        if self._pool is not None and len(busy) > 1:
            t0 = time.perf_counter()
            futs = [(t, self._pool.submit(t.engine.step)) for t in busy]
            for tier, fut in futs:
                dl = self._deadline(tier)
                try:
                    if dl is None:
                        rep = fut.result()
                    else:
                        rep = fut.result(
                            timeout=max(0.0, t0 + dl - time.perf_counter()))
                    el = time.perf_counter() - t0
                    outcomes.append(("slow", rep)
                                    if dl is not None and el > dl
                                    else ("ok", rep))
                except FuturesTimeout:
                    tier.inflight = fut
                    outcomes.append(("timeout", None))
                except Exception as e:
                    outcomes.append(("error", e))
        else:
            for tier in busy:
                dl = self._deadline(tier)
                s0 = time.perf_counter()
                try:
                    rep = tier.engine.step()
                except Exception as e:
                    outcomes.append(("error", e))
                    continue
                el = time.perf_counter() - s0
                # serial steps cannot be preempted; the watchdog is post-hoc
                outcomes.append(("slow", rep)
                                if dl is not None and el > dl
                                else ("ok", rep))
        return outcomes

    def _report_ok(self, tier: EngineTier, rep) -> bool:
        """Reject corrupt step reports (NaN timings, impossible token
        counts) before they reach streams' accounting or the shared
        tracker — a sick device lies; the supervisor must not believe
        it."""
        if not isinstance(rep, StepReport):
            return False
        eng = tier.engine
        cap = eng.max_slots * max(1, eng.decode_quantum)
        return (math.isfinite(rep.dt) and rep.dt >= 0
                and 0 <= rep.decoded <= cap
                and 0 <= rep.admitted <= eng.max_slots
                and 0 <= rep.accepted <= max(rep.proposed, 0))

    def _set_health(self, tier: EngineTier, state: str, reason: str) -> None:
        if state == tier.health:
            return
        self.health_log.append({"cycle": self.cycles, "tier": tier.name,
                                "from": tier.health, "to": state,
                                "reason": reason})
        tier.health = state

    def _observe_success(self, tier: EngineTier) -> None:
        tier.fail_streak = 0
        if tier.health == DEGRADED:
            self._set_health(tier, HEALTHY, "clean step")
        elif tier.health == PROBATION:
            tier.probation_ok += 1
            if tier.probation_ok >= self.policy.probation_steps:
                tier.quarantine_len = self.policy.quarantine_cycles
                self._set_health(tier, HEALTHY,
                                 f"{tier.probation_ok} clean canary steps")

    def _observe_failure(self, tier: EngineTier, reason: str) -> None:
        tier.fail_streak += 1
        tier.failures += 1
        if tier.health == PROBATION:
            # the canary failed: straight back, exponentially longer hold
            self._quarantine(tier, f"canary failed: {reason}", doubled=True)
        elif tier.fail_streak >= self.policy.quarantine_after:
            self._quarantine(tier, reason)
        else:
            self._set_health(tier, DEGRADED, reason)

    def _quarantine(self, tier: EngineTier, reason: str, *,
                    doubled: bool = False) -> None:
        if doubled:
            tier.quarantine_len = min(max(tier.quarantine_len, 1) * 2, 64)
        else:
            tier.quarantine_len = self.policy.quarantine_cycles
        tier.quarantined_at = self.cycles
        tier.probation_ok = 0
        self._set_health(tier, QUARANTINED, reason)
        if tier.inflight is None:
            self._reclaim_tier(tier)
        else:
            tier.reclaimed = False     # deferred until the thread lets go

    def _reclaim_tier(self, tier: EngineTier) -> None:
        """Pull every request off a quarantined tier — un-admitted pending
        and admitted in-flight alike — releasing its pages
        (`Engine.abort`). Both go through the retry law: a pending request
        has no tokens to resume (it re-queues verbatim) but its attempt
        still counts, otherwise a request repeatedly routed to a tier
        that dies with it pending would bounce forever instead of
        converging to a dead letter. Admission leftovers reclaimed from
        *healthy* tiers (in ``step``) stay penalty-free — refusal is
        backpressure, not failure."""
        tier.reclaimed = True
        try:
            reqs = tier.engine.take_pending() + tier.engine.abort()
        except Exception:              # engine too broken even to reclaim;
            return                     # its requests will hit the stall law
        for req in reqs:
            if self.assigned.pop(req.rid, None) is not None:
                tier.routed -= 1
        tier.reclaims += len(reqs)
        self._retry(reqs, tier)

    def _retry(self, reqs: list[Request], tier: EngineTier) -> None:
        """Request-level retry (§8): each failed request re-enters the
        queue after exponential backoff, re-prefilled from its original
        prompt plus already-emitted tokens (`plan_resume`) so greedy
        recovery is token-identical; past the budget it is dead-lettered."""
        eos = self.tiers[0].engine.eos_id
        for req in reqs:
            ent = self._resume.get(req.rid)
            if ent is None:
                ent = {"req": req, "prompt": list(req.prompt),
                       "max_new": req.max_new, "prefix": [], "attempts": 0}
                self._resume[req.rid] = ent
            ent["attempts"] += 1
            if ent["attempts"] > self.policy.retry_budget:
                self._dead_letter(
                    req, f"retry budget of {self.policy.retry_budget} "
                         f"exhausted (last failure on tier {tier.name})")
                continue
            plan = plan_resume(req.prompt, req.out, req.max_new, eos)
            if plan is None:
                self._finish_resume(req, mark_done=True)   # already terminal
                continue
            prompt, remaining = plan
            if all(len(prompt) >= t.engine.max_len for t in self.tiers):
                # context-capped: the unfailed stream would have ended here
                self._finish_resume(req, mark_done=True)
                continue
            ent["prefix"].extend(req.out)
            req.prompt, req.max_new, req.out = prompt, remaining, []
            req.done = False
            delay = self.policy.retry_backoff * (1 << (ent["attempts"] - 1))
            self._delayed.append((self.cycles + delay, req))
            self.retries += 1

    def _dead_letter(self, req: Request, msg: str) -> None:
        """Terminal failure: restore the request's original identity and
        partial stream, record the typed error, stop tracking it.
        ``req.done`` stays False — the stream did NOT complete."""
        ent = self._resume.pop(req.rid, None)
        if ent is not None:
            req.prompt = ent["prompt"]
            req.max_new = ent["max_new"]
            req.out = ent["prefix"] + req.out
        self.dead_letters[req.rid] = RequestFailedError(
            f"request {req.rid}: {msg}")

    def _finish_resume(self, req: Request, *, mark_done: bool) -> None:
        """A retried stream terminated: stitch the emitted prefix back and
        restore the caller-visible prompt/budget."""
        ent = self._resume.pop(req.rid, None)
        if ent is not None:
            req.prompt = ent["prompt"]
            req.max_new = ent["max_new"]
            req.out = ent["prefix"] + req.out
        if mark_done:
            req.done = True

    def _finish_retries(self) -> None:
        for rid in [rid for rid, ent in self._resume.items()
                    if ent["req"].done]:
            self._finish_resume(self._resume[rid]["req"], mark_done=False)

    def _release_delayed(self) -> None:
        if not self._delayed:
            return
        ready = [r for c, r in self._delayed if c <= self.cycles]
        self._delayed = [(c, r) for c, r in self._delayed if c > self.cycles]
        self.queue.extend(ready)

    def _poll_inflight(self) -> None:
        """Collect step futures that earlier blew their deadline. Their
        report is discarded (whatever tokens the hung quantum emitted are
        already in the request streams and covered by the resume law);
        a tier quarantined while its thread still ran is reclaimed now."""
        for tier in self.tiers:
            fut = tier.inflight
            if fut is None or not fut.done():
                continue
            tier.inflight = None
            try:
                fut.result()
            except Exception:
                pass
            if tier.health == QUARANTINED and not tier.reclaimed:
                self._reclaim_tier(tier)

    def _advance_health(self) -> None:
        for tier in self.tiers:
            if (tier.health == QUARANTINED and tier.reclaimed
                    and tier.inflight is None
                    and self.cycles - tier.quarantined_at
                    >= tier.quarantine_len):
                tier.fail_streak = 0
                tier.probation_ok = 0
                self._set_health(tier, PROBATION,
                                 f"quarantine of {tier.quarantine_len} "
                                 f"cycles served")

    # ---- drive to completion ---------------------------------------------
    def _guard_limit(self) -> int:
        """Aggregate of the per-engine guard: every request needs ≲ one
        admission cycle plus max_new/quantum decode cycles; 8× slack."""
        quantum = min(t.engine.decode_quantum for t in self.tiers)
        reqs = list(self.queue) + [r for _, r in self._delayed]
        for t in self.tiers:
            reqs += t.engine.pending
            reqs += [r for r in t.engine.slot_req if r is not None]
        tokens = sum(max(1, r.max_new) for r in reqs)
        # §8 slack: every retry replays admission + decode, and failed
        # requests idle through quarantine holds and exponential backoff
        p = self.policy
        recovery = 8 * (p.retry_budget + 1) * (
            p.quarantine_cycles + (p.retry_backoff << p.retry_budget))
        return 64 + recovery + 8 * (len(reqs) + -(-tokens // quantum))

    def run(self, requests: list[Request]) -> list[Request]:
        """Serve ``requests`` to completion across the pool. Raises
        :class:`EngineStallError` with per-tier diagnostics if the pool
        stops making progress (scheduling bug or global starvation) —
        but only *after* failure hygiene (§8): every tier's slots and
        pages are reclaimed and every unfinished request is dead-lettered
        with a :class:`~repro_torch.serve.engine.RequestFailedError` recording
        the stall, so the caller sees per-request terminal states and the
        pool is clean for fresh submissions, not half-drained.

        Requests that were dead-lettered *during* a successful run (retry
        budget exhausted) do not raise — check ``dead_letters`` /
        ``Request.done``."""
        for r in requests:
            self.submit(r)
        guard, limit = 0, self._guard_limit()
        while self.has_work():
            if guard >= limit:
                diag = (
                    f"multi-engine made no progress after {guard} cycles "
                    f"(limit {limit}): {len(self.queue)} queued, "
                    f"{len(self._delayed)} backing off; "
                    + "; ".join(self._tier_diag(t) for t in self.tiers))
                self._fail_outstanding(f"pool stalled — {diag}")
                raise EngineStallError(diag)
            self.step()
            guard += 1
        return requests

    def _fail_outstanding(self, reason: str) -> None:
        """Stall hygiene: reclaim every tier (slots emptied, pages
        released — the allocator invariant holds afterwards) and
        dead-letter every unfinished request with its partial stream
        restored. A tier whose hung step thread still owns its engine is
        skipped — touching it would race the thread; its requests are
        dead-lettered from the bookkeeping side only."""
        orphans: list[Request] = []
        for t in self.tiers:
            if t.inflight is not None:
                continue
            try:
                orphans += t.engine.take_pending()
                orphans += t.engine.abort()
            except Exception:
                pass
        orphans += self.queue + [r for _, r in self._delayed]
        self.queue, self._delayed = [], []
        for req in orphans:
            if not req.done:
                self._dead_letter(req, reason)

    def drain(self) -> None:
        """Finish all admitted and queued work without new submissions."""
        self.run([])

    def _tier_diag(self, tier: EngineTier) -> str:
        eng = tier.engine
        busy = sum(1 for r in eng.slot_req if r is not None)
        d = (f"{tier.name}: {tier.health}, {len(eng.pending)} pending, "
             f"{busy}/{eng.max_slots} slots busy, "
             f"{tier.failures} failures")
        if tier.inflight is not None:
            d += ", step thread hung"
        if eng.paged:
            d += f", {len(eng.alloc.free)} pages free"
        return d

    # ---- reporting -------------------------------------------------------
    def stats(self) -> dict:
        """Aggregated completion/throughput report across tiers."""
        snap = self.tracker.snapshot()
        tiers = {}
        for t in self.tiers:
            s = snap[t.name]
            tiers[t.name] = {
                "kind": t.kind,
                "routed": t.routed,
                "decoded": t.decoded,
                "accepted": t.accepted,
                "proposed": t.proposed,
                "acceptance": (t.accepted / t.proposed if t.proposed else 0.0),
                "tok_s": s.ewma_thr,
                "busy_time": s.busy_time,
                "unit_cost": t.unit_cost,
                "health": t.health,
                "failures": t.failures,
                "reclaims": t.reclaims,
            }
        return {"cycles": self.cycles, "queued": len(self.queue),
                "retries": self.retries,
                "dead_letters": {rid: str(e)
                                 for rid, e in self.dead_letters.items()},
                "tiers": tiers}


def make_multi_engine(cfg: ModelConfig, tier_kws: list[dict], *,
                      seed: int = 0, device=None, concurrent: bool = True,
                      policy: HealthPolicy | None = None,
                      **shared_kw) -> MultiEngine:
    """Build a tier pool over ONE shared parameter set
    (``init_params(cfg, seed)`` on ``device``, the card unless
    ``device="cpu"``).

    Each dict in ``tier_kws`` holds that tier's Engine kwargs plus the
    optional routing keys ``name`` / ``kind`` / ``unit_cost`` /
    ``prior_tok_s``; ``shared_kw`` is merged under every tier (tier keys
    win). A tier is dense unless its keys say ``paged=True`` (the JAX
    default, so one dict builds the same layout in both packages). Sharing
    the parameters is what makes the tiers token-equivalent at
    ``temperature=0``, and costs one copy of the model, not N.

    A big/little speculative tier rides the same mechanism: pass that
    tier ``draft_cfg``/``draft_params``/``spec_k`` in its dict (the draft's
    parameters on ``device``); at ``temperature=0`` its stream is the
    plain tiers' token for token, so pool outputs stay tier-independent.

        meng = make_multi_engine(cfg, [
            {"name": "dense"},
            {"name": "paged", "paged": True, "page_size": 8},
        ], max_slots=4, max_len=128)
    """
    params = init_params(cfg, seed=seed, device=device)
    tiers = []
    for i, kw in enumerate(tier_kws):
        kw = {"paged": False, **shared_kw, **kw}
        name = kw.pop("name", f"tier{i}")
        kind = kw.pop("kind", "core")
        unit_cost = kw.pop("unit_cost", 1.0)
        prior = kw.pop("prior_tok_s", 1.0)
        tiers.append(EngineTier(name, Engine(cfg, params, device=device,
                                             **kw),
                                kind=kind, unit_cost=unit_cost,
                                prior_tok_s=prior))
    return MultiEngine(tiers, concurrent=concurrent, policy=policy)
