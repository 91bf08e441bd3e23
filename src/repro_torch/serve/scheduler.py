"""Request-granularity routing across heterogeneous engine tiers
(``repro/serve/scheduler.py``, whole).

The paper's dynamic scheduler (§3) splits an iteration space across a pool
of CPU cores and an FPGA in proportion to each resource's *measured*
throughput. At serving granularity the iteration space is the queue of
pending requests, measured in **token units** (prompt tokens + decode
budget), and the resources are `Engine` tiers (device classes, cache
layouts, or model sizes). This module is the pure routing law consumed by
:class:`repro_torch.serve.multi_engine.MultiEngine`:

* :func:`request_units` — the work measure of one request;
* :func:`route_requests` — one routing round: split the queued units over
  the tiers with :func:`repro_torch.core.chunking.proportional_split` (per-tier
  measured tok/s over token-unit cost), respecting per-tier admission
  capacity and per-request tier eligibility;
* :func:`apply_health` — the quarantine/probation capacity mask of the
  tier health supervisor (DESIGN.md §8): a quarantined tier takes
  nothing, a probation tier takes at most one canary request.

Work conservation: a tier with no capacity this round (slots full, pool
exhausted, stalled) simply takes nothing — its proportional share spills to
the live tiers instead of queueing behind the dead one. Requests beyond the
aggregate capacity stay queued (global admission backpressure).

Speculative tiers need no special casing here: an engine decoding with a
draft model reports *emitted* tokens per quantum (accepted draft tokens
plus the verify correction — DESIGN.md §7), so the measured tok/s this
module divides by unit cost is already the acceptance-scaled **effective**
speed. Acceptance collapsing on some workload shows up as a falling
measured speed, and the proportional law sheds load from that tier with
no extra signal.
"""
from __future__ import annotations

from typing import Optional, Sequence

from repro_torch.core.chunking import proportional_split


# Tier health states (DESIGN.md §8). Pure strings so the state machine is
# trivially serializable/loggable.
HEALTHY = "healthy"          # full proportional share
DEGRADED = "degraded"        # recent failure(s), still below the
#                              quarantine threshold — routes normally
QUARANTINED = "quarantined"  # masked out entirely; in-flight reclaimed
PROBATION = "probation"      # re-admitted with a single canary request
HEALTH_STATES = (HEALTHY, DEGRADED, QUARANTINED, PROBATION)


def apply_health(capacities: Sequence[int], states: Sequence[str],
                 busy: Sequence[int], *, canary: int = 1) -> list[int]:
    """Mask per-tier routing capacity by tier health.

    The quarantine/probation law expressed on capacities, which is how
    :func:`route_requests` already encodes dead tiers (capacity 0 takes
    nothing and its proportional share spills to the live tiers — same
    work-conservation path as a stalled or pool-exhausted tier):

    * ``quarantined`` — capacity 0: the tier is ineligible for every
      request this cycle, full stop.
    * ``probation`` — at most ``canary`` requests in flight across slots
      and pending (``busy[i]``): the tier must prove itself on a single
      canary before its full share is restored; a second request is not
      risked on a tier that just came out of quarantine.
    * ``healthy`` / ``degraded`` — untouched. Degraded is a bookkeeping
      state (failures seen, threshold not reached); starving it would turn
      one transient fault into a self-fulfilling outage.

    Pure host code, unit-testable without engines.
    """
    if not len(capacities) == len(states) == len(busy):
        raise ValueError(f"{len(capacities)} capacities, {len(states)} "
                         f"states, {len(busy)} busy counts")
    out = []
    for c, s, b in zip(capacities, states, busy):
        if s not in HEALTH_STATES:
            raise ValueError(f"unknown health state {s!r} "
                             f"(expected one of {HEALTH_STATES})")
        if s == QUARANTINED:
            out.append(0)
        elif s == PROBATION:
            out.append(min(int(c), max(0, canary - int(b))))
        else:
            out.append(int(c))
    return out


def request_units(prompt_len: int, max_new: int) -> int:
    """Token units of one request: prompt tokens to prefill plus the decode
    budget. This is the unit `proportional_split` divides across tiers, and
    the same unit the single-engine HBB admission law budgets in."""
    return max(1, prompt_len) + max(0, max_new)


def tier_speeds(throughputs: Sequence[float], priors: Sequence[float],
                unit_costs: Sequence[float]) -> list[float]:
    """Effective routing speed per tier: measured tok/s (falling back to the
    tier's prior until the tracker has a sample) divided by the tier's
    token-unit cost. A tier twice as expensive per token (energy, $/hour,
    contention) is routed half the work its raw throughput would earn."""
    out = []
    for thr, prior, cost in zip(throughputs, priors, unit_costs):
        eff = thr if thr > 0 else max(prior, 1e-9)
        out.append(eff / max(cost, 1e-9))
    return out


def route_requests(units: Sequence[int], speeds: Sequence[float],
                   capacities: Sequence[int],
                   eligible: Optional[Sequence[Sequence[bool]]] = None,
                   ) -> list[list[int]]:
    """One routing round: assign queued requests to tiers.

    Args:
      units: token units per queued request, FIFO order
        (:func:`request_units`).
      speeds: effective speed per tier (:func:`tier_speeds`).
      capacities: how many requests each tier can accept right now
        (free decode slots; 0 for a stalled or saturated tier).
      eligible: optional per-request tier masks — ``eligible[j][i]`` is
        False when request ``j`` can never run on tier ``i`` (e.g. its
        prompt exceeds that tier's ``max_len``). Default: everywhere.

    Returns:
      Per-tier lists of queue indices, in queue order. The concatenation is
      a subset of ``range(len(units))``; whatever is missing stays queued.

    The split targets `proportional_split(total_units, speeds)` over the
    *live* tiers (capacity > 0): each request goes to the eligible live
    tier with the largest remaining target, so cumulative shares converge
    to the proportional law while FIFO order is preserved per tier. Dead
    tiers take nothing and their share spills to the rest — queued work is
    never blocked behind a stalled tier.

    Assignment considers the most-constrained requests first (fewest
    eligible live tiers; FIFO among equals): a request that can only run
    on one tier — e.g. a long prompt that only the long-context tier can
    hold — claims that tier's capacity before universally-eligible
    requests spill onto it, so scarce tiers serve the work only they can.
    """
    n = len(speeds)
    if len(capacities) != n:
        raise ValueError(f"{len(capacities)} capacities for {n} tiers")
    assign: list[list[int]] = [[] for _ in range(n)]
    if not units:
        return assign
    cap = [int(c) for c in capacities]
    live = [i for i in range(n) if cap[i] > 0]
    if not live:
        return assign
    spd = [max(float(s), 1e-9) for s in speeds]
    total = int(sum(units))
    share = proportional_split(total, [spd[i] for i in live])
    deficit = dict(zip(live, share))

    def n_eligible(j: int) -> int:
        if eligible is None:
            return len(live)
        return sum(1 for i in live if eligible[j][i])

    order = sorted(range(len(units)), key=lambda j: (n_eligible(j), j))
    for j in order:
        u = units[j]
        best = None
        for i in live:
            if cap[i] <= 0:
                continue
            if eligible is not None and not eligible[j][i]:
                continue
            if best is None or deficit[i] > deficit[best]:
                best = i
        if best is None:
            # every eligible tier is full; other requests may still fit a
            # different tier, so keep scanning instead of breaking
            continue
        assign[best].append(j)
        deficit[best] -= u
        cap[best] -= 1
    for lst in assign:
        lst.sort()                 # FIFO order within each tier
    return assign
