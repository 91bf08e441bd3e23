"""The decode quantum as one device program, on the CPU, at the smoke
configs of the served models in f32: the in-place quantum
(``decode_quantum``) against the functional ``decode_loop`` bit for bit,
greedy and sampled, on page pools and on dense rows and rings; and the
paged and dense engines with a CPU stand-in for their CUDA graphs
(``serve/graphs.py``) against the JAX fast engine of the same layout. The
stand-in captures by running the quantum once and replays by running it
again, and asserts that a replay reads the storage the capture read: what
a CUDA graph, whose pointers are fixed at capture, needs. Parameters come
from the JAX initializer, inputs from numpy seeds."""
import dataclasses

import jax
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro.configs import all_configs, smoke_config
from repro.models.model import model_defs
from repro.serve.engine import Request as JRequest
from repro.serve.engine import make_engine as jmake_engine
from repro.sharding import params as prm
from repro.sharding.axes import single_device_ctx
from repro_torch import configs as tconfigs
from repro_torch.params import init_params, params_from_numpy, tree_map
from repro_torch.serve import engine as teng
from repro_torch.serve import graphs
from repro_torch.serve.decode import _pack, decode_loop, decode_quantum
from repro_torch.serve.kv_cache import (cache_defs, make_cache,
                                        paged_cache_defs)

ARCHS = ["mistral-nemo-12b", "deepseek-v2-236b", "phi3.5-moe-42b-a6.6b",
         "mamba2-130m"]
# both engines admit with this HBB speed ratio: on the MoE models capacity
# couples the rows of a prefill group (as tests/test_torch_moe.py), and the
# widths the quanta take follow admission
PINNED_F = 0.01
SAMPLED = dict(temperature=0.8, top_k=50, top_p=0.9)


def _tcfg(arch):
    return dataclasses.replace(tconfigs.smoke_config(tconfigs.get_config(
        arch)), param_dtype="float32")


# ------------------------------------------------------ in-place quantum
def _state(cfg, B=4, T=4, ps=8, seed=0):
    """A random mid-decode state: pools and Mamba-2 states, a page table of
    distinct pages, positions (the last slot frozen at max_len), tokens,
    masks and budgets."""
    rng = np.random.default_rng(seed)
    N = 1 + B * T
    cache = make_cache(paged_cache_defs(cfg, num_pages=N, page_size=ps,
                                        max_slots=B, max_len=T * ps), "cpu")
    for layer in cache["layers"]:
        for t in layer.values():
            t.copy_(torch.from_numpy(rng.normal(size=t.shape) * 0.5))
    slots = dict(
        tokens=torch.from_numpy(rng.integers(0, cfg.vocab, B).astype(
            np.int32)),
        pos=torch.tensor([5, 2 * ps + 3, 9, T * ps], dtype=torch.int32),
        active=torch.tensor([True, True, False, True]),
        remaining=torch.tensor([6, 2, 3, 9], dtype=torch.int32))
    pt = torch.from_numpy((1 + rng.permutation(N - 1).reshape(B, T)).astype(
        np.int32))
    return cache, slots, pt


@pytest.mark.parametrize("sampling", ["greedy", "sampled"])
@pytest.mark.parametrize("arch", ["gemma2-2b", "h2o-danube-1.8b"])
def test_inplace_quantum_dense_matches_decode_loop(arch, sampling):
    """The dense engine's quantum (no page table; every row dense, rings of
    the smoke window 32 at max_len 48, slots before and past a wrap, one
    frozen at max_len): in place equals ``decode_loop`` bit for bit, and
    every cache leaf is written in place (none rebound)."""
    cfg = _tcfg(arch)
    params = init_params(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(0)
    B, max_len = 4, 48
    cache = make_cache(cache_defs(cfg, max_slots=B, max_len=max_len), "cpu")
    for layer in cache["layers"]:
        for t in layer.values():
            t.copy_(torch.from_numpy(rng.normal(size=t.shape) * 0.5))
    slots = dict(
        tokens=torch.from_numpy(rng.integers(0, cfg.vocab, B).astype(
            np.int32)),
        pos=torch.tensor([5, 30, 40, max_len], dtype=torch.int32),
        active=torch.tensor([True, True, True, False]),
        remaining=torch.tensor([6, 8, 3, 9], dtype=torch.int32))
    kw = dict(num_steps=4, eos_id=-1, max_len=max_len,
              **(SAMPLED if sampling == "sampled" else {}))
    ref_cache = tree_map(lambda t: t.clone(), cache)
    carry, toks, msks = decode_loop(
        cfg, params, ref_cache, *(t.clone() for t in slots.values()),
        page_table=None, generator=torch.Generator().manual_seed(3), **kw)
    leaves = tree_leaves(cache)
    packed = torch.full((9, 4), -7, dtype=torch.int32)
    decode_quantum(cfg, params, cache, *slots.values(), None, packed,
                   generator=torch.Generator().manual_seed(3), **kw)
    assert torch.equal(packed, _pack(carry[3], toks, msks))
    for name, want in zip(slots, carry[1:]):
        assert torch.equal(slots[name], want), name
    for layer, ref in zip(cache["layers"], carry[0]["layers"]):
        for name, t in layer.items():
            assert torch.equal(t, ref[name]), name
    # the dense rows and rings are written in place: decode_loop hands back
    # the leaves it was given, and the quantum rebinds none
    assert all(a is b for a, b in zip(
        tree_leaves(carry[0]), tree_leaves(ref_cache)))
    assert all(a is b for a, b in zip(tree_leaves(cache), leaves))


@pytest.mark.parametrize("sampling", ["greedy", "sampled"])
@pytest.mark.parametrize("arch", ARCHS)
def test_inplace_quantum_matches_decode_loop(arch, sampling):
    cfg = _tcfg(arch)
    params = init_params(cfg, seed=0, device="cpu")
    cache, slots, pt = _state(cfg)
    kw = dict(num_steps=4, eos_id=-1, max_len=pt.shape[1] * 8,
              **(SAMPLED if sampling == "sampled" else {}))
    ref_cache = tree_map(lambda t: t.clone(), cache)
    carry, toks, msks = decode_loop(
        cfg, params, ref_cache, *(t.clone() for t in slots.values()),
        page_table=pt, generator=torch.Generator().manual_seed(3), **kw)
    before = tree_map(lambda t: t.clone(), cache)
    given = {n: t for n, t in slots.items()}
    packed = torch.full((9, 4), -7, dtype=torch.int32)
    decode_quantum(cfg, params, cache, *slots.values(), pt, packed,
                   generator=torch.Generator().manual_seed(3), **kw)
    assert torch.equal(packed, _pack(carry[3], toks, msks))
    for name, want in zip(slots, carry[1:]):
        assert slots[name] is given[name]
        assert slots[name].dtype == want.dtype
        assert torch.equal(slots[name], want), name
    changed = 0
    for layer, ref, old in zip(cache["layers"], carry[0]["layers"],
                               before["layers"]):
        for name, t in layer.items():
            assert torch.equal(t, ref[name]), name
            changed += not torch.equal(t, old[name])
    assert changed == sum(len(layer) for layer in cache["layers"])
    assert 0 < int(packed[4:8].sum()) < 16      # masks: some slots emitted


# --------------------------------------------- engine through a stand-in
class _Reads(TorchDispatchMode):
    """Records, in order, the storage of every tensor an op reads that no
    earlier op of the run made: what the run reads from outside. A constant
    the run makes with ``torch.tensor`` enters through ``lift_fresh`` and
    is not read from outside."""

    def __init__(self):
        super().__init__()
        self.made, self.seen, self.read = set(), set(), []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        fresh = func is torch.ops.aten.lift_fresh.default
        for t in () if fresh else tree_leaves((args, kwargs)):
            if isinstance(t, torch.Tensor):
                p = t.untyped_storage().data_ptr()
                if p and p not in self.made and p not in self.seen:
                    self.seen.add(p)
                    self.read.append(p)
        out = func(*args, **kwargs)
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                p = t.untyped_storage().data_ptr()
                if p not in self.seen:
                    self.made.add(p)
        return out


def _reads(fn) -> list[int]:
    with _Reads() as mode:
        fn()
    return mode.read


class _Replay:
    def __init__(self, fn, reads):
        self.fn, self.reads = fn, reads
        self.replays = 0

    def replay(self):
        assert _reads(self.fn) == self.reads, \
            "a replay reads storage other than the capture's"
        self.replays += 1


class StandInGraphs(graphs.DecodeGraphs):
    """CPU stand-in for the engine's CUDA graphs: a capture runs the
    quantum once (the warm-up, its one real run) and records the storage it
    reads; a replay runs it again and asserts the same storage is read in
    the same order."""

    def _capture(self, fn):
        return _Replay(fn, _reads(fn)), (0,) * len(graphs.COUNTERS)


def _workload(arch, vocab):
    """The engine workloads of tests/test_torch_serve.py and
    tests/test_torch_mamba.py; the attention models at page size 4 and
    max_len 128, so their quanta take more than one page-table width."""
    if arch == "mamba2-130m":
        lens, kw = [5, 5, 9, 17, 40, 70], dict(max_slots=2, max_len=96,
                                               page_size=8, decode_quantum=3)
        budget = [6] * len(lens)
    else:
        lens, kw = [4, 5, 9, 17, 18, 23, 63], dict(
            max_slots=3, max_len=128, page_size=4, decode_quantum=4)
        budget = [1 if i == 1 else 6 for i in range(len(lens))]
    rng = np.random.default_rng(3)
    return [rng.integers(0, vocab, n).tolist() for n in lens], budget, kw


def _standin_engine(tcfg, tp, monkeypatch, kw, **extra):
    eng = teng.Engine(tcfg, tp, device="cpu", **kw, **extra)
    eng.graphs = StandInGraphs(eng.device, eng._gen)
    decode_records = []
    record = eng.tracker.record
    monkeypatch.setattr(eng.tracker, "record", lambda kind, *a: (
        decode_records.append(kind) if kind == "decode" else None,
        record(kind, *a))[1])
    return eng, decode_records


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_standin_graphs_match_jax(arch, monkeypatch):
    jcfg = dataclasses.replace(smoke_config(all_configs()[arch]),
                               param_dtype="float32")
    tcfg = _tcfg(arch)
    jp = prm.materialize(model_defs(jcfg), jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    prompts, budget, kw = _workload(arch, tcfg.vocab)
    jeng = jmake_engine(jcfg, single_device_ctx(), paged=True, **kw)
    monkeypatch.setattr(jeng.tracker, "f", lambda: PINNED_F)
    jreqs = [JRequest(rid=i, prompt=p, max_new=n)
             for i, (p, n) in enumerate(zip(prompts, budget))]
    jeng.run(jreqs)
    fetches = []
    fetch = teng._host_fetch
    monkeypatch.setattr(teng, "_host_fetch",
                        lambda x: fetches.append(1) or fetch(x))
    eng, decode_records = _standin_engine(tcfg, tp, monkeypatch, kw)
    monkeypatch.setattr(eng.tracker, "f", lambda: PINNED_F)
    reqs = [teng.Request(rid=i, prompt=p, max_new=n)
            for i, (p, n) in enumerate(zip(prompts, budget))]
    eng.run(reqs)
    assert all(r.done for r in reqs)
    assert [r.out for r in reqs] == [r.out for r in jreqs], \
        [(a.out, b.out) for a, b in zip(jreqs, reqs)]
    eng.alloc.check()
    assert len(eng.alloc.free) == eng.alloc.usable_pages
    # one capture per live page-table width (a model without a page pool
    # shares one graph), every other quantum a replay
    widths = set(eng.widths_used)
    assert eng.decode_captures == len(widths)
    if "paged" in eng.kinds:
        assert len(widths) > 1 and widths <= {8, 16, 32}, widths
    else:
        assert widths == {96 // 8}
    replays = sum(g.replays for g, _ in eng.graphs._graphs.values())
    assert replays == eng.quanta - eng.decode_captures > 0
    # JAX's warm rule: the capturing quanta are not in the tracker
    assert len(decode_records) == eng.quanta - eng.decode_captures
    assert len(fetches) == eng.quanta + eng.prefill_groups


STANDIN_LAYOUTS = [("gemma2-2b", True), ("gemma2-2b", False),
                   ("h2o-danube-1.8b", False)]


@pytest.mark.parametrize("arch,paged", STANDIN_LAYOUTS,
                         ids=[f"{a}-{'paged' if p else 'dense'}"
                              for a, p in STANDIN_LAYOUTS])
def test_engine_standin_graphs_rings_and_dense_match_jax(arch, paged,
                                                         monkeypatch):
    """Ring leaves beside the pools (gemma2 paged) and the dense engine
    (gemma2, danube: no page table) through the stand-in graphs, against
    the JAX fast engine of the same layout: identical streams past the
    smoke window, every replay reading the storage its capture read (ring
    slots computed on the device from ``pos``; no leaf rebound), one
    capture per width (the dense engine: one graph), the capturing quanta
    out of the tracker, one host read per quantum and group."""
    jcfg = dataclasses.replace(smoke_config(all_configs()[arch]),
                               param_dtype="float32")
    tcfg = _tcfg(arch)
    jp = prm.materialize(model_defs(jcfg), jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    prompts, _, kw = _workload(arch, tcfg.vocab)
    budget = [1 if i == 1 else 30 for i in range(len(prompts))]
    jeng = jmake_engine(jcfg, single_device_ctx(), paged=paged, **kw)
    monkeypatch.setattr(jeng.tracker, "f", lambda: PINNED_F)
    jreqs = [JRequest(rid=i, prompt=p, max_new=n)
             for i, (p, n) in enumerate(zip(prompts, budget))]
    jeng.run(jreqs)
    fetches = []
    fetch = teng._host_fetch
    monkeypatch.setattr(teng, "_host_fetch",
                        lambda x: fetches.append(1) or fetch(x))
    eng, decode_records = _standin_engine(tcfg, tp, monkeypatch, kw,
                                          paged=paged)
    monkeypatch.setattr(eng.tracker, "f", lambda: PINNED_F)
    leaves = tree_leaves(eng.cache)
    reqs = [teng.Request(rid=i, prompt=p, max_new=n)
            for i, (p, n) in enumerate(zip(prompts, budget))]
    eng.run(reqs)
    assert all(r.done for r in reqs)
    assert [r.out for r in reqs] == [r.out for r in jreqs], \
        [(a.out, b.out) for a, b in zip(jreqs, reqs)]
    assert max(len(p) + len(r.out) for p, r in zip(prompts, reqs)) > 32
    assert all(a is b for a, b in zip(tree_leaves(eng.cache), leaves))
    widths = set(eng.widths_used)
    assert eng.decode_captures == len(widths)
    assert widths == ({8, 16, 32} & widths if paged else {0})
    replays = sum(g.replays for g, _ in eng.graphs._graphs.values())
    assert replays == eng.quanta - eng.decode_captures > 0
    assert len(decode_records) == eng.quanta - eng.decode_captures
    assert len(fetches) == eng.quanta + eng.prefill_groups


def test_engine_standin_graphs_sampled_match_eager(monkeypatch):
    """Sampled streams (temperature 0.8, top-k 50, top-p 0.9, one seed)
    through the stand-in equal the eager engine's: a replay draws from the
    generator as the eager quantum does."""
    tcfg = _tcfg("mistral-nemo-12b")
    tp = init_params(tcfg, seed=0, device="cpu")
    prompts, budget, kw = _workload("mistral-nemo-12b", tcfg.vocab)
    outs = []
    for stand_in in (False, True):
        if stand_in:
            eng, _ = _standin_engine(tcfg, tp, monkeypatch, kw,
                                     sample_seed=5, **SAMPLED)
        else:
            eng = teng.Engine(tcfg, tp, device="cpu", sample_seed=5, **kw,
                              **SAMPLED)
        eng.tracker.f = lambda: PINNED_F
        reqs = [teng.Request(rid=i, prompt=p, max_new=8)
                for i, p in enumerate(prompts)]
        eng.run(reqs)
        outs.append([r.out for r in reqs])
    assert eng.decode_captures == len(eng.widths_used) > 1
    assert outs[0] == outs[1]


def test_engine_capture_failure_raises(monkeypatch):
    """A capture that fails raises out of ``step``: no eager retry, and no
    graph is kept for the width."""
    tcfg = _tcfg("mistral-nemo-12b")
    tp = init_params(tcfg, seed=0, device="cpu")
    prompts, _, kw = _workload("mistral-nemo-12b", tcfg.vocab)

    class Failing(graphs.DecodeGraphs):
        def _capture(self, fn):
            raise RuntimeError("capture refused")

    eng = teng.Engine(tcfg, tp, device="cpu", **kw)
    eng.graphs = Failing(eng.device, eng._gen)
    eng.submit(teng.Request(rid=0, prompt=prompts[0], max_new=6))
    with pytest.raises(RuntimeError, match="capture refused"):
        eng.step()
    assert eng.quanta == 0 and eng.decode_captures == 0
    assert not eng.graphs._graphs


def test_engine_graphs_need_the_card():
    tcfg = _tcfg("mistral-nemo-12b")
    tp = init_params(tcfg, seed=0, device="cpu")
    with pytest.raises(ValueError, match="card"):
        teng.Engine(tcfg, tp, device="cpu", graphs=True)
    eng = teng.Engine(tcfg, tp, device="cpu")
    assert eng.graphs is None and eng.decode_captures == 0


def test_graph_replays_add_the_captured_launch_counts():
    """``run`` captures at a key's first call and replays at every later
    one; each replay adds the wrapper counts the capture recorded, the
    capture itself none."""
    delta = (2,) + (0,) * (len(graphs.COUNTERS) - 2) + (1,)

    class Counted(graphs.DecodeGraphs):
        def _capture(self, fn):
            fn()
            return _Replay(fn, []), delta

    g = Counted("cpu", torch.Generator())
    before = graphs.launch_counts()
    assert g.run(8, lambda: None) is True
    assert graphs.launch_counts() == before
    assert [g.run(8, lambda: None) for _ in range(3)] == [False] * 3
    assert g.run(16, lambda: None) is True
    after = graphs.launch_counts()
    assert g.captures == 2 and sorted(g._graphs) == [8, 16]
    assert after[0] == before[0] + 6 and after[-1] == before[-1] + 3
    assert after[1:-1] == before[1:-1]
    graphs.add_launches(tuple(b - a for a, b in zip(after, before)))
    assert graphs.launch_counts() == before

