"""The port's tier pool (``serve/multi_engine.py``) on the CPU, at the smoke
config of mistral-nemo-12b in f32 over the JAX initializer's parameters:
every test of the JAX package's ``tests/test_multi_engine.py`` on the
port; pool streams token-identical to the JAX fast engine's; routing
pinned to the tiers' priors giving JAX's ``MultiEngine``'s assignments;
a tier that recovers keeping its captured graphs (the CPU stand-in of
``tests/test_torch_decode_graph.py``); and launch counts that stay exact
when several threads launch and capture."""
import dataclasses
import functools
import threading

import jax
import numpy as np
import pytest
import torch

from repro.configs import all_configs, smoke_config
from repro.models.model import model_defs
from repro.serve.engine import Engine as JEngine
from repro.serve.engine import Request as JRequest
from repro.serve.faults import Fault as JFault
from repro.serve.faults import FaultyEngine as JFaultyEngine
from repro.serve.multi_engine import EngineTier as JEngineTier
from repro.serve.multi_engine import HealthPolicy as JHealthPolicy
from repro.serve.multi_engine import MultiEngine as JMultiEngine
from repro.sharding import params as prm
from repro.sharding.axes import single_device_ctx
from repro_torch import configs as tconfigs
from repro_torch.kernels import _launches
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.paged_attention import ops as paged_ops
from repro_torch.params import params_from_numpy
from repro_torch.serve import graphs
from repro_torch.serve.engine import (Engine, EngineStallError,
                                      PromptTooLongError, Request,
                                      StepReport, make_engine)
from repro_torch.serve.faults import Fault, FaultyEngine
from repro_torch.serve.multi_engine import (EngineTier, HealthPolicy,
                                            MultiEngine, make_multi_engine)
from repro_torch.serve.scheduler import HEALTHY, PROBATION, QUARANTINED
from test_torch_decode_graph import StandInGraphs

ARCH = "mistral-nemo-12b"          # full attention → paged tiers exercised
MAX_NEW = 12                       # the reference streams' budget
# every engine of a pinned-routing comparison admits with this HBB ratio
PINNED_F = 0.01


def _jcfg():
    return dataclasses.replace(smoke_config(all_configs()[ARCH]),
                               param_dtype="float32")


def _tcfg():
    return dataclasses.replace(tconfigs.smoke_config(
        tconfigs.get_config(ARCH)), param_dtype="float32")


@functools.cache
def _params():
    """The JAX initializer's parameters, and the same numbers on the
    port."""
    jp = prm.materialize(model_defs(_jcfg()), jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), _tcfg(),
                           device="cpu")
    return jp, tp


def _prompts(n, lo=4, hi=31, seed=3, vocab=512):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, int(x)).tolist()
            for x in rng.integers(lo, hi, n)]


PROMPTS = _prompts(8)


@functools.cache
def _jax_streams() -> tuple[tuple[int, ...], ...]:
    """The JAX fast engine's greedy stream of each of PROMPTS, MAX_NEW
    tokens; a shorter budget's stream is its prefix."""
    jp, _ = _params()
    eng = JEngine(_jcfg(), jp, single_device_ctx(), max_slots=2, max_len=64,
                  decode_quantum=4)
    reqs = [JRequest(rid=i, prompt=p, max_new=MAX_NEW)
            for i, p in enumerate(PROMPTS)]
    eng.run(reqs)
    return tuple(tuple(r.out) for r in reqs)


def reference(prompts, max_new):
    """The JAX fast engine's streams of ``prompts`` (some of PROMPTS)."""
    assert max_new <= MAX_NEW
    streams = _jax_streams()
    return [list(streams[PROMPTS.index(p)][:max_new]) for p in prompts]


def requests(prompts, max_new=6, rid0=0):
    return [Request(rid=rid0 + i, prompt=list(p), max_new=max_new)
            for i, p in enumerate(prompts)]


def pool(tier_kws, *, concurrent=True, policy=None, **shared_kw):
    """``make_multi_engine`` over the shared JAX-initialized parameters (a
    tier is dense unless it says ``paged=True``, as in both packages)."""
    _, tp = _params()
    tiers = []
    for i, kw in enumerate(tier_kws):
        kw = {"paged": False, **shared_kw, **kw}
        name = kw.pop("name", f"tier{i}")
        route = {k: kw.pop(k) for k in ("kind", "unit_cost", "prior_tok_s")
                 if k in kw}
        tiers.append(EngineTier(name, Engine(_tcfg(), tp, device="cpu",
                                             **kw), **route))
    return MultiEngine(tiers, concurrent=concurrent, policy=policy)


def assert_pool_clean(meng):
    """Zero page leaks and empty slots on every tier."""
    for t in meng.tiers:
        eng = getattr(t.engine, "engine", t.engine)   # unwrap FaultyEngine
        assert all(r is None for r in eng.slot_req), t.name
        if eng.paged:
            eng.alloc.check()
            assert len(eng.alloc.free) == eng.alloc.usable_pages, t.name


DENSE_PAGED = [{"name": "dense"},
               {"name": "paged", "paged": True, "page_size": 8}]


# ------------------------------------------------------- engine tier surface
def test_step_report_and_tier_interface():
    """Engine.step exposes per-quantum token throughput; plan_admission and
    take_pending give a router slot- and pool-aware control."""
    cfg = _tcfg()
    eng = make_engine(cfg, device="cpu", max_slots=2, max_len=64,
                      decode_quantum=4)
    assert not eng.paged and eng.stream is None    # JAX's default layout
    reqs = requests(_prompts(3, vocab=cfg.vocab))
    assert eng.plan_admission(reqs) == 2           # slot-capped
    for r in reqs:
        eng.submit(r)
    assert eng.has_work()
    rep = eng.step()
    assert isinstance(rep, StepReport)
    assert rep.admitted >= 1 and rep.decoded >= 1 and rep.dt > 0
    assert rep.warm and rep.accepted == rep.proposed == 0
    left = eng.take_pending()                      # un-admitted work back
    assert eng.pending == [] and all(isinstance(r, Request) for r in left)
    for r in left:
        eng.submit(r)
    eng.drain()
    assert not eng.has_work() and all(r.done for r in reqs)
    assert eng.decode_throughput() > 0
    with pytest.raises(ValueError, match="step_deadline_s"):
        make_engine(cfg, device="cpu", step_deadline_s=0.0)


def test_plan_admission_pool_capped():
    """A paged engine's plan_admission stops at the pool's worst-case
    commit budget, not just at free slots."""
    pages = 1 + 64 // 8                            # one full context only
    eng = make_engine(_tcfg(), device="cpu", max_slots=4, max_len=64,
                      paged=True, page_size=8, num_pages=pages)
    reqs = [Request(rid=i, prompt=[1] * 40, max_new=20) for i in range(3)]
    assert eng.plan_admission(reqs) == 1, (
        "pool holds one worst-case context; admission must stop there")


# ----------------------------------------------------------- pool behaviour
def test_multi_engine_validation():
    cfg = _tcfg()
    with pytest.raises(ValueError):
        MultiEngine([])
    meng = make_multi_engine(cfg, [{"name": "a"}, {"name": "b"}],
                             device="cpu", max_slots=2, max_len=64)
    assert [t.engine.paged for t in meng.tiers] == [False, False]
    with pytest.raises(ValueError):                # duplicate names
        make_multi_engine(cfg, [{"name": "a"}, {"name": "a"}],
                          device="cpu", max_slots=2, max_len=64)
    with pytest.raises(ValueError):                # shared engine object
        MultiEngine([EngineTier("x", meng.tiers[0].engine),
                     EngineTier("y", meng.tiers[0].engine)])
    with pytest.raises(ValueError):
        make_multi_engine(cfg, [{"name": "a", "kind": "gpu"}],
                          device="cpu", max_slots=2, max_len=64)
    with pytest.raises(ValueError):
        meng.submit(Request(rid=0, prompt=[], max_new=2))
    with pytest.raises(PromptTooLongError):        # too long for EVERY tier
        meng.submit(Request(rid=0, prompt=[1] * 64, max_new=2))
    with pytest.raises(ValueError):
        HealthPolicy(quarantine_after=0)


@pytest.mark.parametrize("concurrent", [False, True],
                         ids=["serial", "concurrent"])
def test_multi_tier_token_equivalence(concurrent):
    """The same workload through a heterogeneous dense+paged pool, through
    one port engine and through the JAX fast engine gives identical greedy
    streams per request: which tier served a request does not change its
    tokens."""
    prompts = PROMPTS[:7]
    budget = [1 if i == 2 else 6 for i in range(len(prompts))]
    meng = pool(DENSE_PAGED, concurrent=concurrent, max_slots=2, max_len=64,
                decode_quantum=4)
    multi = [Request(rid=i, prompt=p, max_new=n)
             for i, (p, n) in enumerate(zip(prompts, budget))]
    meng.run(multi)
    assert all(r.done for r in multi)
    assert all(t.routed > 0 for t in meng.tiers), meng.stats()
    assert set(meng.assigned) == {r.rid for r in multi}
    assert not meng.health_log and not meng.dead_letters
    _, tp = _params()
    eng = Engine(_tcfg(), tp, device="cpu", paged=False, max_slots=2,
                 max_len=64, decode_quantum=4)
    single = [Request(rid=i, prompt=p, max_new=n)
              for i, (p, n) in enumerate(zip(prompts, budget))]
    eng.run(single)
    ref = [s[:n] for s, n in zip(reference(prompts, 6), budget)]
    for a, b, want in zip(multi, single, ref):
        assert a.out == b.out == want, (a.rid, meng.assigned[a.rid])
    assert_pool_clean(meng)


def test_multi_tier_long_prompt_routes_to_capable_tier():
    """Prompts too long for the short tier are only eligible on the long
    tier; shorts and longs complete side by side."""
    cfg = _tcfg()
    meng = pool([{"name": "short", "max_len": 48},
                 {"name": "long", "max_len": 128}],
                max_slots=2, decode_quantum=4)
    reqs = [Request(rid=0, prompt=_prompts(1, 90, 91, vocab=cfg.vocab)[0],
                    max_new=4)]
    reqs += requests(_prompts(3, vocab=cfg.vocab), max_new=4, rid0=1)
    meng.run(reqs)
    assert all(r.done for r in reqs)
    assert meng.assigned[0] == "long"


def test_stalled_tier_reroutes_work():
    """All slots of one tier are pinned by a long-running request; queued
    work flows through the other tier instead of blocking (work
    conservation), and the pool does not stall."""
    cfg = _tcfg()
    meng = pool([{"name": "a"}, {"name": "b"}], max_slots=1, max_len=64,
                decode_quantum=2, concurrent=False)
    blocker = Request(rid=99, prompt=[1, 2, 3], max_new=40)
    tier_b = meng.tiers[1]
    tier_b.engine.submit(blocker)                  # pin b's only slot
    tier_b.engine.step()
    assert not tier_b.engine.free_slots()
    shorts = requests(_prompts(4, vocab=cfg.vocab), max_new=3)
    meng.run(shorts)
    assert all(r.done for r in shorts)
    assert all(meng.assigned[r.rid] == "a" for r in shorts), meng.assigned
    tier_b.engine.drain()                          # let the blocker finish
    assert blocker.done


def test_pool_exhausted_tier_reroutes_work():
    """A paged tier whose pool cannot commit another request has zero
    effective capacity; queued work reroutes to the dense tier."""
    cfg = _tcfg()
    pages = 1 + 64 // 8                            # one worst-case context
    meng = pool([{"name": "dense"},
                 {"name": "paged", "paged": True, "page_size": 8,
                  "num_pages": pages}],
                max_slots=2, max_len=64, decode_quantum=2, concurrent=False)
    hog = Request(rid=99, prompt=[1] * 10, max_new=50)
    paged = meng.tiers[1]
    paged.engine.submit(hog)                       # commits the whole pool
    paged.engine.step()
    assert paged.engine.plan_admission(
        [Request(rid=98, prompt=[1] * 8, max_new=8)]) == 0
    reqs = requests(_prompts(4, vocab=cfg.vocab), max_new=3)
    meng.run(reqs)
    assert all(r.done for r in reqs)
    assert all(meng.assigned[r.rid] == "dense" for r in reqs), meng.assigned
    paged.engine.drain()
    assert hog.done


def test_multi_engine_throughput_routing_skew():
    """With strongly skewed *measured* tier speeds, the proportional law
    routes most requests to the fast tier (the shared tracker primed by
    hand instead of timing real quanta)."""
    cfg = _tcfg()
    meng = pool([{"name": "fast"}, {"name": "slow"}], max_slots=6,
                max_len=64, decode_quantum=4, concurrent=False)
    for _ in range(6):                             # converge the EWMA
        meng.tracker.record("fast", 900, 1.0)
        meng.tracker.record("slow", 100, 1.0)
    reqs = requests(_prompts(6, vocab=cfg.vocab), max_new=4)
    meng.run(reqs)
    assert all(r.done for r in reqs)
    fast = sum(1 for r in reqs if meng.assigned[r.rid] == "fast")
    assert fast >= 4, meng.assigned


def test_multi_engine_stall_reports_per_tier():
    """A hung tier (its step makes no progress) trips the pool's guard with
    per-tier diagnostics instead of spinning forever."""
    meng = pool([{"name": "only"}], max_slots=1, max_len=64,
                decode_quantum=2, concurrent=False)
    meng.tiers[0].engine.step = lambda: StepReport()    # hung device
    with pytest.raises(EngineStallError, match="only:"):
        meng.run([Request(rid=1, prompt=[4, 5], max_new=2)])


# ---------------------------------------------------------- against JAX's
def _pin(meng):
    """Routing at the tiers' priors and every engine's HBB ratio pinned."""
    meng.tracker.throughput = lambda name: 0.0
    for t in meng.tiers:
        eng = getattr(t.engine, "engine", t.engine)
        eng.tracker.f = lambda: PINNED_F


@pytest.mark.parametrize("concurrent", [False, True],
                         ids=["serial", "concurrent"])
def test_pinned_routing_matches_jax(concurrent):
    """Routing pinned to the tiers' priors (3:1) and both packages'
    engines admitting at one HBB ratio: the port's pool assigns every
    request to the tier JAX's ``MultiEngine`` does over the same tiers,
    routes the same counts each cycle, and emits the same streams."""
    jp, _ = _params()
    kws = [dict(name="dense", prior_tok_s=3.0, max_len=64),
           dict(name="paged", prior_tok_s=1.0, max_len=64, paged=True,
                page_size=8)]
    shared = dict(max_slots=2, decode_quantum=4)
    jtiers = []
    for kw in kws:
        kw = {**shared, **kw}
        name, prior = kw.pop("name"), kw.pop("prior_tok_s")
        jtiers.append(JEngineTier(name, JEngine(_jcfg(), jp,
                                                single_device_ctx(), **kw),
                                  prior_tok_s=prior))
    jm = JMultiEngine(jtiers, concurrent=False)
    _pin(jm)
    jreqs = [JRequest(rid=i, prompt=p, max_new=6)
             for i, p in enumerate(PROMPTS)]
    jm.run(jreqs)
    tm = pool(kws, concurrent=concurrent, **shared)
    _pin(tm)
    treqs = requests(PROMPTS)
    tm.run(treqs)
    assert tm.assigned == jm.assigned
    assert [c["routed"] for c in tm.cycle_log] == \
        [c["routed"] for c in jm.cycle_log]
    assert [r.out for r in treqs] == [r.out for r in jreqs]
    assert {t.name: t.routed for t in tm.tiers} == \
        {t.name: t.routed for t in jm.tiers}
    assert all(t.routed > 0 for t in tm.tiers)
    assert_pool_clean(tm)


def test_faulted_pool_matches_jax_faulted_pool():
    """One raise fault on the paged tier, the same in both packages (its
    schedule drawn from one seed): the same health transitions at the same
    cycles, the same retries and the same streams."""
    jp, _ = _params()
    policy = dict(quarantine_after=2, quarantine_cycles=1,
                  probation_steps=1, retry_backoff=0)
    fault = dict(kind="raise", p=0.25, seed=4, n=2)
    jm = JMultiEngine([
        JEngineTier("dense", JEngine(_jcfg(), jp, single_device_ctx(),
                                     max_slots=2, max_len=64,
                                     decode_quantum=4), prior_tok_s=2.0),
        JEngineTier("paged", JFaultyEngine(
            JEngine(_jcfg(), jp, single_device_ctx(), max_slots=2,
                    max_len=64, decode_quantum=4, paged=True, page_size=8),
            [JFault(**fault)]))],
        concurrent=False, policy=JHealthPolicy(**policy))
    _pin(jm)
    jreqs = [JRequest(rid=i, prompt=p, max_new=MAX_NEW)
             for i, p in enumerate(PROMPTS)]
    jm.run(jreqs)
    tm = pool([dict(name="dense", prior_tok_s=2.0),
               dict(name="paged", paged=True, page_size=8)],
              concurrent=False, policy=HealthPolicy(**policy), max_slots=2,
              max_len=64, decode_quantum=4)
    tm.tiers[1].engine = FaultyEngine(tm.tiers[1].engine, [Fault(**fault)])
    _pin(tm)
    treqs = requests(PROMPTS, max_new=MAX_NEW)
    tm.run(treqs)
    assert tm.tiers[1].engine.fault_log, "the fault never fired"
    assert tm.health_log == jm.health_log
    assert tm.retries == jm.retries > 0
    assert [r.out for r in treqs] == [r.out for r in jreqs] == \
        reference(PROMPTS, MAX_NEW)
    assert_pool_clean(tm)


# ------------------------------------------------- graphs of a recovered tier
def test_recovered_tier_keeps_its_graphs(monkeypatch):
    """A tier decoding through the CPU stand-in of its CUDA graphs fails
    two steps, is quarantined, comes back through probation and serves
    again with the graphs it captured before: no capture at a width it had
    captured, the same graph objects, and every replay reading the storage
    its capture read (the stand-in asserts it). Streams match JAX's."""
    meng = pool(DENSE_PAGED, concurrent=False, max_slots=2, max_len=64,
                decode_quantum=4,
                policy=HealthPolicy(quarantine_after=2, quarantine_cycles=1,
                                    probation_steps=1, retry_backoff=0))
    for t in meng.tiers:
        t.engine.graphs = StandInGraphs(t.engine.device, t.engine._gen)
    sick = meng.tiers[1]
    eng = sick.engine
    warm = requests(PROMPTS[6:], max_new=6, rid0=50)
    meng.run(warm)                                 # captures every width
    graphs_before = dict(eng.graphs._graphs)
    widths_before = set(eng.widths_used)
    quanta_before = eng.quanta
    assert graphs_before and eng.decode_captures == len(widths_before)
    sick.engine = FaultyEngine(eng, [Fault(kind="raise", at=(1,), n=2)])
    reqs = requests(PROMPTS[:6], max_new=MAX_NEW)
    meng.run(reqs)
    states = [h["to"] for h in meng.health_log if h["tier"] == "paged"]
    assert states[:3] == ["degraded", QUARANTINED, PROBATION], states
    assert states[-1] == HEALTHY
    assert eng.quanta > quanta_before + 2          # served after recovery
    assert set(eng.widths_used) == widths_before
    assert eng.decode_captures == len(widths_before)
    assert all(eng.graphs._graphs[k] is v for k, v in graphs_before.items())
    assert [r.out for r in reqs] == reference(PROMPTS[:6], MAX_NEW)
    assert_pool_clean(meng)


# ------------------------------------------------ launch counts and threads
def test_launch_counts_exact_under_threads():
    """Concurrent wrappers lose no update: 16 threads (more than the
    cores), switching every microsecond, counting 20,000 launches each add
    exactly 320,000, and each thread's own count holds its own launches
    only."""
    import sys
    before = paged_ops.launches
    mine = []

    def launch():
        for _ in range(20000):
            _launches.bump(paged_ops.__name__, "launches")
        mine.append(_launches.thread_count(paged_ops.__name__, "launches"))

    threads = [threading.Thread(target=launch) for _ in range(16)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert paged_ops.launches - before == 320000
    assert mine == [20000] * 16
    paged_ops.launches = before


def test_capture_records_only_its_own_thread():
    """While a stand-in capture runs, another thread (another tier's step)
    launches: those launches stay counted and out of the capture's
    change; the capture's own launches are taken back, and each replay
    adds exactly them."""
    other_go, other_done = threading.Event(), threading.Event()

    def other_tier():
        other_go.wait()
        for _ in range(5):
            _launches.bump(flash_ops.__name__, "launches")
            _launches.bump(paged_ops.__name__, "launches")
        other_done.set()

    def quantum():                                 # the captured function
        _launches.bump(paged_ops.__name__, "launches")
        other_go.set()
        assert other_done.wait(10)
        _launches.bump(paged_ops.__name__, "launches")

    class Capturing(graphs.DecodeGraphs):
        def _capture(self, fn):
            return _Replay(), graphs.counted(fn)

    class _Replay:
        def replay(self):
            pass

    worker = threading.Thread(target=other_tier)
    worker.start()
    g = Capturing("cpu", torch.Generator())
    i_paged = graphs.COUNTERS.index((paged_ops, "launches"))
    i_flash = graphs.COUNTERS.index((flash_ops, "launches"))
    before = graphs.launch_counts()
    assert g.run(8, quantum) is True
    worker.join(10)
    assert not worker.is_alive()
    after = graphs.launch_counts()
    assert after[i_paged] - before[i_paged] == 5   # the other thread's
    assert after[i_flash] - before[i_flash] == 5
    _, delta = g._graphs[8]
    assert delta[i_paged] == 2 and sum(delta) == 2
    assert g.run(8, quantum) is False              # a replay
    assert graphs.launch_counts()[i_paged] - after[i_paged] == 2
    graphs.add_launches(tuple(b - a for a, b in
                              zip(graphs.launch_counts(), before)))
    assert graphs.launch_counts() == before
