"""The tier pool's pure laws against the JAX package's: the routing law
(``route_requests``, ``tier_speeds``, ``request_units``), the health mask
(``apply_health``), the resume law (``plan_resume``) and the fault
schedules (``Fault.schedule``), compared on random inputs with
hypothesis; and the JAX package's pure routing tests
(``tests/test_multi_engine.py``) on the port's copies."""
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.serve import faults as jfaults
from repro.serve import scheduler as jsched
from repro.serve.decode import plan_resume as jplan_resume
from repro_torch.serve import faults as tfaults
from repro_torch.serve import scheduler as tsched
from repro_torch.serve.decode import plan_resume
from repro_torch.serve.scheduler import (request_units, route_requests,
                                         tier_speeds)

PROPS = settings(max_examples=300, deadline=None)


@st.composite
def _routing(draw):
    """A queue of token units, per-tier speeds and capacities, and (or
    not) a per-request eligibility mask."""
    n_tiers = draw(st.integers(1, 5))
    units = draw(st.lists(st.integers(1, 4000), max_size=24))
    speeds = draw(st.lists(st.floats(0.0, 1e4, allow_nan=False),
                           min_size=n_tiers, max_size=n_tiers))
    caps = draw(st.lists(st.integers(-1, 9), min_size=n_tiers,
                         max_size=n_tiers))
    eligible = None
    if draw(st.booleans()):
        eligible = [draw(st.lists(st.booleans(), min_size=n_tiers,
                                  max_size=n_tiers)) for _ in units]
    return units, speeds, caps, eligible


@PROPS
@given(_routing())
def test_route_requests_matches_jax(case):
    units, speeds, caps, eligible = case
    assert route_requests(units, speeds, caps, eligible) == \
        jsched.route_requests(units, speeds, caps, eligible)


@PROPS
@given(st.lists(st.tuples(st.floats(-5.0, 1e5, allow_nan=False),
                          st.floats(-1.0, 1e3, allow_nan=False),
                          st.floats(-1.0, 50.0, allow_nan=False)),
                max_size=6),
       st.integers(-3, 5000), st.integers(-3, 5000))
def test_tier_speeds_and_request_units_match_jax(rows, prompt, budget):
    thr, priors, costs = ([r[i] for r in rows] for i in range(3))
    assert tier_speeds(thr, priors, costs) == \
        jsched.tier_speeds(thr, priors, costs)
    assert request_units(prompt, budget) == \
        jsched.request_units(prompt, budget)


@PROPS
@given(st.lists(st.tuples(st.integers(-2, 9),
                          st.sampled_from(tsched.HEALTH_STATES),
                          st.integers(0, 9)), max_size=6),
       st.integers(0, 3))
def test_apply_health_matches_jax(rows, canary):
    caps, states, busy = ([r[i] for r in rows] for i in range(3))
    assert tsched.HEALTH_STATES == jsched.HEALTH_STATES
    assert tsched.apply_health(caps, states, busy, canary=canary) == \
        jsched.apply_health(caps, states, busy, canary=canary)


@PROPS
@given(st.lists(st.integers(0, 50), max_size=20),
       st.lists(st.integers(0, 50), max_size=20), st.integers(0, 30),
       st.integers(-1, 50))
def test_plan_resume_matches_jax(prompt, out, max_new, eos):
    assert plan_resume(prompt, out, max_new, eos) == \
        jplan_resume(prompt, out, max_new, eos)


@PROPS
@given(st.sampled_from(tfaults.FAULT_KINDS),
       st.lists(st.integers(0, 80), max_size=4), st.integers(0, 7),
       st.integers(0, 6), st.floats(0.0, 1.0, allow_nan=False),
       st.integers(0, 2**32 - 1), st.integers(1, 5), st.integers(0, 120))
def test_fault_schedule_matches_jax(kind, at, every, phase, p, seed, n,
                                    horizon):
    """The same Fault fires at the same steps in both packages: the
    Bernoulli draws come from numpy's ``default_rng(seed)`` in both."""
    kw = dict(kind=kind, at=tuple(at), every=every, phase=phase, p=p,
              seed=seed, n=n)
    assert tfaults.Fault(**kw).schedule(horizon) == \
        jfaults.Fault(**kw).schedule(horizon)
    assert tfaults.FAULT_KINDS == jfaults.FAULT_KINDS


# ------------------------------------------------------------ pure routing
def test_route_requests_converges_to_proportional_shares():
    """Skewed per-tier throughput → cumulative token-unit shares converge
    to the proportional law (3:1 within a few percent), with FIFO order
    preserved per tier."""
    speeds = [3.0, 1.0]
    done = [0, 0]
    rng = np.random.default_rng(0)
    for _ in range(200):
        units = [int(u) for u in rng.integers(5, 40, 8)]
        assign = route_requests(units, speeds, capacities=[8, 8])
        for i, idxs in enumerate(assign):
            assert idxs == sorted(idxs)            # FIFO within tier
            done[i] += sum(units[j] for j in idxs)
        assert sorted(assign[0] + assign[1]) == list(range(len(units)))
    share = done[0] / (done[0] + done[1])
    assert abs(share - 0.75) < 0.05, (done, share)


def test_route_requests_capacity_and_spill():
    """A tier with no capacity takes nothing; its share spills to the live
    tiers; requests beyond aggregate capacity stay queued."""
    units = [10, 10, 10, 10, 10]
    a = route_requests(units, [1.0, 5.0], [3, 0])
    assert a[1] == [] and a[0] == [0, 1, 2]        # spill + backpressure
    a = route_requests(units, [1.0, 5.0], [0, 0])
    assert a == [[], []]
    with pytest.raises(ValueError):
        route_requests(units, [1.0], [1, 1])


def test_route_requests_eligibility_and_constrained_first():
    """A request eligible on only one tier claims that tier's scarce
    capacity before universally-eligible requests spill onto it."""
    units = [10, 10, 10, 30]                       # last: long request
    eligible = [[True, True]] * 3 + [[False, True]]
    a = route_requests(units, [1.0, 1.0], [2, 1], eligible)
    assert 3 in a[1] and 3 not in a[0]
    assert len(a[0]) == 2 and len(a[1]) == 1       # capacity respected
    # nothing eligible anywhere stays queued rather than erroring
    a = route_requests([5], [1.0, 1.0], [1, 1], [[False, False]])
    assert a == [[], []]


def test_tier_speeds_prior_and_unit_cost():
    assert tier_speeds([0.0, 100.0], [2.0, 1.0], [1.0, 4.0]) == [2.0, 25.0]
    assert request_units(10, 6) == 16
    assert request_units(0, 0) == 1
