"""The port's fault-tolerant tier pool on the CPU (``serve/faults.py``,
``serve/multi_engine.py``'s supervisor), at the smoke config of
mistral-nemo-12b in f32 over the JAX initializer's parameters: every test
of the JAX package's ``tests/test_faults.py`` on the port, and the fault
matrix {raise, hang, exhaust, nan} × {serial, concurrent} × {dense, paged}
with every recovered stream token-identical to the JAX fast engine's and
every page pool whole afterwards.

Watchdog timing cannot flake: the deadline is ten times the slowest
measured smoke step (at least 0.2 s) and a hang three times the
deadline."""
import functools
import time

import numpy as np
import pytest

from repro_torch.serve.decode import plan_resume
from repro_torch.serve.engine import (Engine, EngineStallError,
                                      PageAllocator, Request,
                                      RequestFailedError, StepReport,
                                      make_engine)
from repro_torch.serve.faults import (FAULT_KINDS, Fault, FaultyEngine,
                                      InjectedFault)
from repro_torch.serve.multi_engine import HealthPolicy
from repro_torch.serve.scheduler import (DEGRADED, HEALTHY, PROBATION,
                                         QUARANTINED, apply_health)
from test_torch_multi_engine import (PROMPTS, _params, _tcfg,
                                     assert_pool_clean, pool, reference,
                                     requests)

FAST_POLICY = dict(quarantine_after=2, quarantine_cycles=1,
                   probation_steps=1, retry_backoff=0)
MAX_NEW_FAULT = 12


@functools.cache
def _timing() -> tuple[float, float]:
    """(deadline, hang) seconds: ten times the slowest smoke step of a warm
    engine (prefill steps included), at least 0.2 s, and a hang of three
    deadlines."""
    _, tp = _params()
    slow = 0.0
    for paged in (False, True):
        eng = Engine(_tcfg(), tp, device="cpu", paged=paged, page_size=8,
                     max_slots=2, max_len=64, decode_quantum=4)
        for _ in range(2):
            for r in requests(PROMPTS[:4]):
                eng.submit(r)
            while eng.has_work():
                t0 = time.perf_counter()
                eng.step()
                slow = max(slow, time.perf_counter() - t0)
    deadline = max(0.2, 10 * slow)
    return deadline, 3 * deadline


# ------------------------------------------------------ deterministic faults
def test_fault_schedule_deterministic():
    """Same Fault fields → bit-identical schedule."""
    f = Fault(kind="raise", p=0.3, seed=7)
    assert f.schedule(256) == Fault(kind="raise", p=0.3, seed=7).schedule(256)
    assert f.schedule(256) != Fault(kind="raise", p=0.3, seed=8).schedule(256)
    assert Fault(kind="hang", at=(3,)).schedule(6) == \
        [False, False, False, True, False, False]
    assert Fault(kind="nan", every=3, phase=1).schedule(7) == \
        [False, True, False, False, True, False, False]
    assert Fault(kind="raise", at=(1,), n=3).schedule(5) == \
        [False, True, True, True, False]
    assert Fault(kind="raise", p=0.5, seed=1).schedule(300)[:64] == \
        Fault(kind="raise", p=0.5, seed=1).schedule(64)


def test_fault_validation():
    with pytest.raises(ValueError):
        Fault(kind="explode")
    with pytest.raises(ValueError):
        Fault(kind="raise", n=0)
    with pytest.raises(ValueError):
        Fault(kind="raise", p=1.5)
    with pytest.raises(ValueError):
        FaultyEngine(object(), ["raise"])          # not Fault instances
    assert set(FAULT_KINDS) == {"raise", "hang", "exhaust", "nan"}


def test_apply_health_capacity_mask():
    """Quarantined takes nothing, probation at most one canary across
    slots+pending, healthy/degraded untouched."""
    caps = [4, 4, 4, 4]
    states = [HEALTHY, DEGRADED, QUARANTINED, PROBATION]
    assert apply_health(caps, states, [0, 0, 0, 0]) == [4, 4, 0, 1]
    assert apply_health(caps, states, [2, 2, 2, 1]) == [4, 4, 0, 0]
    assert apply_health([0], [PROBATION], [0]) == [0]   # canary ≤ capacity
    with pytest.raises(ValueError):
        apply_health([1], ["sick"], [0])
    with pytest.raises(ValueError):
        apply_health([1, 1], [HEALTHY], [0])


def test_plan_resume_law():
    """Re-prefill prompt+out with the leftover budget; None when the stream
    is already terminal (budget spent or EOS)."""
    assert plan_resume([1, 2], [7, 8], 6) == ([1, 2, 7, 8], 4)
    assert plan_resume([1, 2], [], 6) == ([1, 2], 6)   # failed pre-decode
    assert plan_resume([1, 2], [7, 8], 2) is None      # budget spent
    assert plan_resume([1, 2], [7, 9], 6, eos_id=9) is None
    assert plan_resume([1, 2], [9, 7], 6, eos_id=9) == ([1, 2, 9, 7], 4)


def test_page_allocator_check_catches_corruption():
    """The conservation invariant names leaked and double-held pages."""
    alloc = PageAllocator(num_pages=9, max_slots=2, pages_per_slot=4)
    alloc.check()
    alloc.commit(0, 2)
    alloc.grow_to(0, 2)
    alloc.check()
    leaked = alloc.free.pop()                      # page falls off the books
    with pytest.raises(RuntimeError, match="leaked"):
        alloc.check()
    alloc.free.append(leaked)
    alloc.free.append(int(alloc.table[0, 0]))      # double-free: aliased page
    with pytest.raises(RuntimeError, match="double-held"):
        alloc.check()


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_engine_abort_releases_everything(paged):
    """Engine.abort empties the slots, returns the in-flight requests with
    their partial streams, releases every page, and leaves the engine
    reusable."""
    _, tp = _params()
    eng = Engine(_tcfg(), tp, device="cpu", max_slots=2, max_len=64,
                 decode_quantum=4, paged=paged, page_size=8)
    reqs = requests(PROMPTS[:3], max_new=20)
    for r in reqs:
        eng.submit(r)
    eng.step()
    eng.step()                                     # both slots mid-flight
    aborted = eng.abort()
    assert len(aborted) == 2 and all(not r.done for r in aborted)
    assert all(len(r.out) > 0 for r in aborted)    # partial streams kept
    assert all(r is None for r in eng.slot_req)
    assert not eng.active_dev.any() and not eng.remaining_dev.any()
    if paged:
        eng.alloc.check()
        assert len(eng.alloc.free) == eng.alloc.usable_pages
    assert len(eng.take_pending()) == 1            # pending was not aborted
    fresh = Request(rid=9, prompt=list(PROMPTS[3]), max_new=4)
    eng.run([fresh])                               # engine still serves
    assert fresh.done and fresh.out == reference([PROMPTS[3]], 4)[0]


def test_faulty_engine_transparent_without_faults():
    """An empty fault schedule is a perfect proxy: the JAX engine's streams,
    the wrapped engine's surface."""
    _, tp = _params()
    eng = FaultyEngine(Engine(_tcfg(), tp, device="cpu", paged=False,
                              max_slots=2, max_len=64, decode_quantum=4), [])
    reqs = requests(PROMPTS[:3])
    for r in reqs:
        eng.submit(r)
    eng.drain()
    assert [r.out for r in reqs] == reference(PROMPTS[:3], 6)
    assert eng.fault_log == [] and eng.steps_seen > 0
    assert eng.max_len == 64                       # passthrough attrs


def test_faulty_engine_injects_on_schedule():
    """Each fault kind fires exactly where its schedule says."""
    eng = FaultyEngine(
        make_engine(_tcfg(), device="cpu", max_slots=2, max_len=64,
                    decode_quantum=4),
        [Fault(kind="raise", at=(0,)), Fault(kind="nan", at=(1,)),
         Fault(kind="exhaust", at=(0,))])
    assert eng.plan_admission([Request(rid=0, prompt=[1], max_new=2)]) == 0
    assert eng.plan_admission([Request(rid=0, prompt=[1], max_new=2)]) == 1
    with pytest.raises(InjectedFault):
        eng.step()
    rep = eng.step()                               # nan step: corrupt
    assert np.isnan(rep.dt) and rep.decoded > 10**6
    assert not eng.engine.has_work()               # quantum was skipped
    assert eng.fault_log == [(0, "exhaust"), (0, "raise"), (1, "nan")]


# --------------------------------------------------- multi-tier fault matrix
def _scenario(kind, concurrent):
    """(fault, policy, the sick tier's engine keywords, prewarm) of one
    fault kind, as the JAX package's tests set each up."""
    deadline, hang = _timing()
    if kind == "raise":
        return Fault(kind="raise", at=(2,), n=2), FAST_POLICY, {}, False
    if kind == "nan":
        return Fault(kind="nan", at=(1,), n=2), FAST_POLICY, {}, False
    if kind == "exhaust":
        return Fault(kind="exhaust", every=1), {}, {}, False
    if not concurrent:                             # post-hoc watchdog
        return (Fault(kind="hang", at=(1,), n=2, hang_s=hang), FAST_POLICY,
                {"step_deadline_s": deadline}, False)
    # the future times out; the hung thread owns the engine until it ends
    return (Fault(kind="hang", at=(0,), hang_s=hang),
            {**FAST_POLICY, "quarantine_after": 1},
            {"step_deadline_s": deadline}, True)


@pytest.mark.parametrize("layout", ["dense", "paged"])
@pytest.mark.parametrize("concurrent", [False, True],
                         ids=["serial", "concurrent"])
@pytest.mark.parametrize("kind", FAULT_KINDS)
def test_fault_matrix_recovery_token_identical(kind, concurrent, layout):
    """A dense+paged pool whose ``layout`` tier is faulted (the JAX
    package's raise, nan, exhaust and hang-watchdog tests, serial and
    concurrent, on either tier): every request completes with the JAX fast
    engine's greedy stream, no page leaks, prompts and budgets restored.
    raise, nan and hang quarantine the sick tier (nan with a corrupt
    report kept out of the tracker; a concurrent hang reclaimed after its
    thread lets go); exhaust is backpressure: everything routes to the
    live tier and its health never leaves healthy."""
    fault, policy, sick_kw, prewarm = _scenario(kind, concurrent)
    tiers = [{"name": "dense"},
             {"name": "paged", "paged": True, "page_size": 8}]
    i_sick = 0 if layout == "dense" else 1
    tiers[i_sick].update(sick_kw)
    meng = pool(tiers, concurrent=concurrent,
                policy=HealthPolicy(**policy) if policy else None,
                max_slots=2, max_len=64, decode_quantum=4)
    sick = meng.tiers[i_sick]
    if prewarm:                                    # as the JAX test does
        meng.run(requests(PROMPTS[6:], max_new=2, rid0=50))
    sick.engine = FaultyEngine(sick.engine, [fault])
    prompts = PROMPTS[:6]
    reqs = requests(prompts, max_new=MAX_NEW_FAULT)
    meng.run(reqs)
    assert all(r.done for r in reqs) and not meng.dead_letters
    assert [r.out for r in reqs] == reference(prompts, MAX_NEW_FAULT)
    for r, p in zip(reqs, prompts):                # caller's view restored
        assert r.prompt == p and r.max_new == MAX_NEW_FAULT
    assert any(k == kind for _, k in sick.engine.fault_log)
    log = [h for h in meng.health_log if h["tier"] == sick.name]
    states, reasons = [h["to"] for h in log], [h["reason"] for h in log]
    if kind == "exhaust":
        assert all(meng.assigned[r.rid] != sick.name for r in reqs)
        assert sick.health == HEALTHY and sick.failures == 0 and not log
    else:
        assert QUARANTINED in states, meng.health_log
        assert sick.health in (HEALTHY, PROBATION, DEGRADED)
        assert not [h for h in meng.health_log if h["tier"] != sick.name]
    if kind == "raise":
        assert sick.reclaims > 0 and PROBATION in states, meng.stats()
    if kind == "nan":
        assert any("corrupt StepReport" in r for r in reasons)
        for t in meng.tiers:
            assert np.isfinite(meng.tracker.throughput(t.name))
        assert meng.tracker.snapshot()[sick.name].iters_done < 10**6
    if kind == "hang":
        want = "still running" if concurrent else "deadline exceeded"
        assert any(want in r for r in reasons), meng.health_log
        assert sick.inflight is None               # thread collected
    assert_pool_clean(meng)



# ----------------------------------------------- single tier, retry, budget
def test_single_tier_pool_survives_transient_fault():
    """A one-tier pool has nowhere to re-route: recovery is quarantine,
    backoff, probation, and the SAME tier finishing the work."""
    meng = pool([{"name": "only", "paged": True, "page_size": 8}],
                max_slots=2, max_len=64, decode_quantum=4, concurrent=False,
                policy=HealthPolicy(quarantine_after=1, quarantine_cycles=1,
                                    probation_steps=1, retry_backoff=0))
    only = meng.tiers[0]
    only.engine = FaultyEngine(only.engine, [Fault(kind="raise", at=(1,))])
    reqs = requests(PROMPTS[:3])
    meng.run(reqs)
    assert all(r.done for r in reqs) and not meng.dead_letters
    assert [r.out for r in reqs] == reference(PROMPTS[:3], 6)
    assert meng.retries > 0                        # resume law exercised
    assert_pool_clean(meng)


def test_retry_budget_exhausted_dead_letters():
    """A tier that fails every step after its first drives each admitted
    request through the retry budget into ``dead_letters`` as a typed
    ``RequestFailedError``: original prompt/budget restored, partial
    stream kept, ``done`` False, pages released."""
    meng = pool([{"name": "only", "paged": True, "page_size": 8}],
                max_slots=2, max_len=64, decode_quantum=4, concurrent=False,
                policy=HealthPolicy(quarantine_after=1, quarantine_cycles=1,
                                    probation_steps=1, retry_budget=1,
                                    retry_backoff=0))
    only = meng.tiers[0]
    only.engine = FaultyEngine(only.engine,
                               [Fault(kind="raise", at=(1,), n=10**6)])
    prompt = PROMPTS[0]
    req = Request(rid=0, prompt=list(prompt), max_new=12)
    meng.run([req])                                # returns, no raise
    assert not req.done
    assert isinstance(meng.dead_letters[0], RequestFailedError)
    assert "retry budget" in str(meng.dead_letters[0])
    assert req.prompt == prompt and req.max_new == 12
    assert len(req.out) > 0                        # partial stream kept
    assert meng.stats()["dead_letters"], meng.stats()
    assert_pool_clean(meng)
    only.engine = only.engine.engine               # unwrap the fault
    only.health, only.fail_streak = HEALTHY, 0
    req.out, req.done = [], False
    meng.run([req])
    assert req.done and req.out == reference([prompt], 12)[0]
    assert 0 not in meng.dead_letters              # cleared on resubmit


def test_probation_routes_single_canary():
    """While a tier is on probation it is routed at most one request per
    cycle until its clean steps restore the full share."""
    meng = pool([{"name": "a"}, {"name": "b"}], max_slots=4, max_len=64,
                decode_quantum=4, concurrent=False,
                policy=HealthPolicy(quarantine_after=1, quarantine_cycles=1,
                                    probation_steps=3, retry_backoff=0))
    b = meng.tiers[1]
    b.engine = FaultyEngine(b.engine, [Fault(kind="raise", at=(1,))])
    reqs = requests(PROMPTS, max_new=8)
    meng.run(reqs)
    assert all(r.done for r in reqs)
    assert [r.out for r in reqs] == reference(PROMPTS, 8)
    probation_cycles = [c for c in meng.cycle_log
                        if c["health"]["b"] == PROBATION]
    assert probation_cycles, meng.health_log
    for c in probation_cycles:
        assert c["routed"]["b"] <= 1, c


# ----------------------------------------------------- stall-path hygiene
def test_stall_hygiene_dead_letters_and_clean_resubmit():
    """When the stall guard trips, every unfinished request is
    dead-lettered with the stall diagnostics, all pages are back in the
    pool, and a fresh submit on the SAME pool runs cleanly."""
    meng = pool([{"name": "only", "paged": True, "page_size": 8}],
                max_slots=1, max_len=64, decode_quantum=2, concurrent=False)
    eng = meng.tiers[0].engine
    real_step = eng.step
    eng.step = lambda: StepReport()                # wedged device
    reqs = [Request(rid=i, prompt=[3 + i, 4], max_new=2) for i in range(2)]
    with pytest.raises(EngineStallError, match="only:"):
        meng.run(reqs)
    assert all(not r.done for r in reqs)
    assert set(meng.dead_letters) == {0, 1}
    assert all(isinstance(e, RequestFailedError)
               for e in meng.dead_letters.values())
    assert all("stalled" in str(e) for e in meng.dead_letters.values())
    assert not meng.queue and not meng._delayed and not meng._resume
    assert_pool_clean(meng)
    eng.step = real_step                           # device comes back
    fresh = Request(rid=0, prompt=[5, 6, 7], max_new=3)
    meng.run([fresh])
    assert fresh.done and len(fresh.out) == 3
    assert 0 not in meng.dead_letters


def test_submit_rejects_live_request_object():
    """A Request object is single-use until it terminates: double-submit
    while queued or in flight is a typed error, not silent aliasing."""
    meng = pool([{"name": "a"}], max_slots=2, max_len=64, decode_quantum=4,
                concurrent=False)
    req = Request(rid=0, prompt=[1, 2, 3], max_new=20)
    meng.submit(req)
    with pytest.raises(ValueError, match="single-use"):
        meng.submit(req)
    meng.step()                                    # admitted into a slot
    assert not req.done
    with pytest.raises(ValueError, match="single-use"):
        meng.submit(req)
    meng.drain()
    assert req.done
    req.out, req.done = [], False                  # terminal → reusable
    meng.submit(req)
    meng.drain()
    assert req.done

