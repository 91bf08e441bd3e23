"""Speculative big/little decode on the port (``serve/decode.py``'s
verify/commit split, emission law and speculative quantum,
``models/draft.py``, the engine's draft), on the CPU at the smoke configs in
f32 over the JAX initializer's parameters: every test of the JAX package's
``tests/test_spec_decode.py`` mirrored; greedy spec streams against the JAX
fast engine's spec streams and the port's target-only streams for GQA
(dense and paged), MLA + MoE, rings and Mamba-2; ``spec_candidates`` and
``commit_rows`` against JAX's on random inputs; ``decode_verify`` against
JAX's and against K serial ``decode_step``s, and ``decode_commit`` against
n serial writes, for each family; the in-place quantum against the loop
bit for bit, and the engine through the CPU stand-in of its CUDA graphs,
reading and writing only the tensors it was given."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro.configs import all_configs, smoke_config
from repro.models.model import model_defs
from repro.serve import decode as jdec
from repro.serve.engine import Engine as JEngine
from repro.serve.engine import Request as JRequest
from repro.sharding import params as prm
from repro.sharding.axes import single_device_ctx
from repro_torch import configs as tconfigs
from repro_torch.models.draft import draft_from_target, soften_deep_layers
from repro_torch.models.transformer import layer_schedule
from repro_torch.params import init_params, params_from_numpy, tree_map
from repro_torch.serve import decode as tdec
from repro_torch.serve.engine import Engine, Request
from repro_torch.serve.kv_cache import (cache_defs, make_cache,
                                        paged_cache_defs)
from repro_torch.serve.multi_engine import EngineTier, MultiEngine
from test_torch_decode_graph import StandInGraphs

ARCHS = ["mistral-nemo-12b", "deepseek-v2-236b", "gemma2-2b", "mamba2-130m"]
DRAFT = "mistral-nemo-12b"
# every engine of a stream comparison admits with this HBB ratio: MoE
# capacity couples the rows of a prefill group, so groups must match
PINNED_F = 0.01
SAMPLED = dict(temperature=0.8, top_k=50, top_p=0.9)
TOL = 1e-4


def _jcfg(arch):
    return dataclasses.replace(smoke_config(all_configs()[arch]),
                               param_dtype="float32")


def _tcfg(arch):
    return dataclasses.replace(tconfigs.smoke_config(
        tconfigs.get_config(arch)), param_dtype="float32")


@functools.cache
def _params(arch, seed=0):
    """The JAX initializer's parameters, and the same numbers on the port."""
    jp = prm.materialize(model_defs(_jcfg(arch)), jax.random.PRNGKey(seed))
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), _tcfg(arch),
                                 device="cpu")


def _pair(arch):
    """(target cfg, params; draft cfg, params) in both packages: mistral's
    one-layer truncation of itself, else an independent mistral smoke
    draft (seed 7) sharing the smoke vocab."""
    from repro.models.draft import draft_from_target as jdraft
    jp, tp = _params(arch)
    if arch == DRAFT:
        jd = jdraft(_jcfg(arch), jp, 1)
        td = draft_from_target(_tcfg(arch), tp, 1)
    else:
        jd = (_jcfg(DRAFT), _params(DRAFT, 7)[0])
        td = (_tcfg(DRAFT), _params(DRAFT, 7)[1])
    return (jp, tp), jd, td


def _prompts(vocab, lens=(4, 9, 17, 30), seed=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n).tolist() for n in lens]


ENGINE = dict(max_slots=2, max_len=64, decode_quantum=3)


def _serve(cfg, params, prompts, *, max_new=12, **kw):
    eng = Engine(cfg, params, device="cpu", **ENGINE, **kw)
    eng.tracker.f = lambda: PINNED_F
    reqs = [Request(rid=i, prompt=p, max_new=max_new)
            for i, p in enumerate(prompts)]
    eng.run(reqs)
    assert all(r.done for r in reqs)
    return eng, [r.out for r in reqs]


# ------------------------------------------------- greedy token equivalence
@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_spec_token_equivalence(arch, paged, monkeypatch):
    """Greedy speculative decode emits the target-only stream, per family,
    dense and paged, and the JAX fast engine's speculative stream. mistral
    drafts with its own first layer (real acceptance, multi-row commits);
    the others with an independent draft whose proposals are mostly
    rejected (the correction-only path). gemma2's streams pass its smoke
    window of 32 (the ring branch of verify and commit)."""
    (jp, tp), (jdcfg, jdp), (dcfg, dp) = _pair(arch)
    cfg = _tcfg(arch)
    prompts = _prompts(cfg.vocab)
    _, plain = _serve(cfg, tp, prompts, paged=paged)
    kw = dict(paged=paged, page_size=8)
    eng, spec = _serve(cfg, tp, prompts, draft_cfg=dcfg, draft_params=dp,
                       spec_k=3, **kw)
    jeng = JEngine(_jcfg(arch), jp, single_device_ctx(), **ENGINE,
                   draft_cfg=jdcfg, draft_params=jdp, spec_k=3,
                   **(kw if paged else {}))
    monkeypatch.setattr(jeng.tracker, "f", lambda: PINNED_F)
    jreqs = [JRequest(rid=i, prompt=p, max_new=12)
             for i, p in enumerate(prompts)]
    jeng.run(jreqs)
    assert spec == plain
    assert spec == [r.out for r in jreqs]
    assert max(len(p) + len(o) for p, o in zip(prompts, spec)) > 32
    assert eng.spec_proposed > 0
    if arch == DRAFT:
        assert eng.spec_accepted > 0           # the truncated draft agrees
    if paged and "paged" in eng.kinds:
        eng.alloc.check()
        assert len(eng.alloc.free) == eng.alloc.usable_pages


def test_greedy_spec_multi_engine_routing_unchanged():
    """A spec tier beside a plain tier in one pool: every request's output
    equals the single-engine greedy stream whichever tier served it, and
    the pool surfaces each tier's acceptance."""
    _, tp = _params(DRAFT)
    cfg = _tcfg(DRAFT)
    dcfg, dp = draft_from_target(cfg, tp, 1)
    prompts = _prompts(cfg.vocab, lens=(4, 6, 9, 11, 17), seed=5)
    _, plain = _serve(cfg, tp, prompts, max_new=5)

    def tier(name, **kw):
        eng = Engine(cfg, tp, device="cpu", **ENGINE, **kw)
        eng.tracker.f = lambda: PINNED_F
        return EngineTier(name, eng)
    pool = MultiEngine([tier("plain"),
                        tier("spec", draft_cfg=dcfg, draft_params=dp,
                             spec_k=3)], concurrent=False)
    reqs = [Request(rid=i, prompt=p, max_new=5)
            for i, p in enumerate(prompts)]
    pool.run(reqs)
    assert [r.out for r in reqs] == plain
    stats = pool.stats()["tiers"]
    assert set(pool.assigned.values()) == {"plain", "spec"}  # both served
    assert stats["plain"]["proposed"] == 0
    assert stats["spec"]["proposed"] >= stats["spec"]["accepted"] > 0
    assert stats["spec"]["acceptance"] == pytest.approx(
        stats["spec"]["accepted"] / stats["spec"]["proposed"])
    assert 0.0 < stats["spec"]["acceptance"] <= 1.0


# ------------------------------------------------------ acceptance/emission
def _law_ref(proposals, corrections, accept, active, remaining, pos0,
             eos_id, max_len):
    """Serial reference of one speculative round for one slot."""
    k = len(proposals)
    m = 0
    while m < k and accept[m]:
        m += 1
    cand = [proposals[j] if j < m else corrections[m] for j in range(k + 1)]
    emitted = []
    if active:
        emitted.append(cand[0])
        for j in range(1, k + 1):
            if j > m or len(emitted) >= remaining or pos0 + j >= max_len - 1:
                break
            if emitted[-1] == eos_id:
                break
            emitted.append(cand[j])
    return cand, emitted, m


def _law_case(rng, B=8, k=3, vocab=11, eos=5, max_len=32):
    """One random round through the port's law, JAX's and the serial
    reference: all three agree."""
    args = (rng.integers(0, vocab, (B, k)).astype(np.int32),
            rng.integers(0, vocab, (B, k + 1)).astype(np.int32),
            rng.random((B, k)) < 0.6, rng.random(B) < 0.85,
            rng.integers(1, 8, B).astype(np.int32),
            rng.integers(1, max_len, B).astype(np.int32))
    got = tdec.spec_candidates(*map(torch.from_numpy, args), eos_id=eos,
                               max_len=max_len)
    assert [t.dtype for t in got] == [torch.int32, torch.bool, torch.int32,
                                      torch.int32]
    cand, emit, n, m = (t.numpy() for t in got)
    want = jdec.spec_candidates(*map(jnp.asarray, args), eos_id=eos,
                                max_len=max_len)
    for a, b in zip((cand, emit, n, m), want):
        assert np.array_equal(a, np.asarray(b))
    for b in range(B):
        rcand, remit, rm = _law_ref(*(a[b] for a in args), eos, max_len)
        assert m[b] == rm
        assert n[b] == len(remit), (b, n[b], remit)
        assert list(cand[b, emit[b]]) == remit
        assert np.all(emit[b, :n[b]]) and not np.any(emit[b, n[b]:])


def test_acceptance_law_matches_serial_reference():
    """Random verdicts, budgets, EOS hits and max_len walls: the accepted
    prefix, the emitted tokens and the mask agree with the serial
    reference and with JAX's ``spec_candidates``."""
    rng = np.random.default_rng(0)
    for _ in range(40):
        _law_case(rng)


@given(st.integers(min_value=0, max_value=10_000))
@settings(max_examples=25, deadline=None)
def test_acceptance_law_property(seed):
    _law_case(np.random.default_rng(seed))


def _law(P, C, acc, active, remaining, pos0, **kw):
    i32 = torch.int32
    return tdec.spec_candidates(
        torch.tensor(P, dtype=i32), torch.tensor(C, dtype=i32),
        torch.tensor(acc), torch.tensor(active),
        torch.tensor(remaining, dtype=i32), torch.tensor(pos0, dtype=i32),
        **{"eos_id": 7, "max_len": 64, **kw})


def test_acceptance_law_all_accepted_emits_k_plus_one():
    """k accepted proposals → k+1 emitted tokens (the k drafts + bonus)."""
    k = 4
    cand, emit, n, m = _law([list(range(k))], [[9] * (k + 1)],
                            [[True] * k], [True], [16], [1])
    assert int(m[0]) == k and int(n[0]) == k + 1
    assert cand[0].tolist() == list(range(k)) + [9]
    assert bool(emit.all())


def test_acceptance_law_rejection_depth():
    """First rejection at depth d → d accepted drafts + the correction at
    depth d are emitted; later proposals are discarded."""
    cand, emit, n, m = _law([[3, 4, 5]], [[10, 11, 12, 13]],
                            [[True, False, True]], [True], [16], [1])
    assert int(m[0]) == 1 and int(n[0]) == 2
    assert cand[0][emit[0]].tolist() == [3, 11]


def test_acceptance_law_truncation_and_inactive():
    """EOS inside the accepted prefix, the remaining-budget wall, the
    max_len wall, and inactive slots all cut the emission short."""
    C, acc = [[10, 11, 12, 13]], [[True] * 3]
    assert int(_law([[7, 4, 5]], C, acc, [True], [16], [1])[2][0]) == 1
    assert int(_law([[8, 5, 6]], C, acc, [True], [2], [1])[2][0]) == 2
    assert int(_law([[8, 5, 6]], C, acc, [True], [16], [61])[2][0]) == 2
    _, emit, n, _ = _law([[8, 5, 6]], C, acc, [False], [16], [1])
    assert int(n[0]) == 0 and not bool(emit.any())


def test_residual_rejection_sampling_preserves_target_law():
    """The acceptance rule of ``spec_decode_loop`` — accept g~q iff u·q(g) <
    p(g), else draw from norm(max(p−q, 0)) — reproduces p exactly: the
    emitted-token law enumerated over random (p, q) pairs, the residual
    taken by the loop's own torch expressions."""
    rng = np.random.default_rng(1)
    for _ in range(50):
        V = 7
        p = torch.from_numpy(rng.dirichlet(np.ones(V)))
        q = torch.from_numpy(rng.dirichlet(np.ones(V)))
        accept_prob = torch.clamp(p / q, max=1.0)
        p_rej = 1.0 - torch.sum(q * accept_prob)
        r = torch.clamp(p - q, min=0.0)
        r = torch.where(r.sum(-1, keepdim=True) > 0.0, r, p)
        r = r / r.sum()
        out = q * accept_prob + p_rej * r
        np.testing.assert_allclose(out.numpy(), p.numpy(), atol=1e-12)


def test_spec_pos_advance_matches_emissions():
    """Per quantum, every slot's position (mirrored in ``pos_host``)
    advances by exactly the tokens emitted for it — never the proposals —
    and its page grant covers it."""
    _, tp = _params(DRAFT)
    cfg = _tcfg(DRAFT)
    dcfg, dp = draft_from_target(cfg, tp, 1)
    eng = Engine(cfg, tp, device="cpu", max_slots=2, max_len=64,
                 decode_quantum=2, paged=True, page_size=8, draft_cfg=dcfg,
                 draft_params=dp, spec_k=3)
    assert eng.quantum_tokens == 8 and eng.tokens_per_step == 4
    for i, p in enumerate(_prompts(cfg.vocab)):
        eng.submit(Request(rid=i, prompt=p, max_new=24))
    checked = 0
    while eng.has_work():
        before = eng.pos_host.copy()
        req_before = {i: r for i, r in enumerate(eng.slot_req)
                      if r is not None}
        emitted_before = {i: len(r.out) for i, r in req_before.items()}
        eng.step()
        for i, r in req_before.items():
            adv = int(eng.pos_host[i] - before[i])
            assert adv == len(r.out) - emitted_before[i]
            assert adv <= eng.quantum_tokens
            checked += 1
        for i, r in enumerate(eng.slot_req):
            if r is not None:
                have = int(np.sum(eng.alloc.table[i] != 0))
                assert have * eng.page_size >= int(eng.pos_host[i])
    assert checked > 0
    assert torch.equal(eng.pos_dev.long(), torch.from_numpy(eng.pos_host))


# ------------------------------------------------------- multi-token commit
@functools.cache
def _jcommit(window: int, paged: bool):
    """JAX's ``commit_rows``, jitted once per layout (its shard_map would
    otherwise compile at every call)."""
    ctx = single_device_ctx()
    if paged:
        return jax.jit(lambda c, r, p, n, pt: jdec.commit_rows(
            c, r, p, n, ctx, axes=(None, "kv_seq", None, None),
            page_table=pt))
    return jax.jit(lambda c, r, p, n: jdec.commit_rows(
        c, r, p, n, ctx, window=window, axes=("batch", "kv_seq", None,
                                              None)))


def _commit_case(seed, B=3, K=4, T=6, ps=4, npages=25):
    """``commit_rows`` on a paged leaf ≡ K serial ``_paged_write``s with the
    rejected rows sent to the trash page ≡ JAX's ``commit_rows``; every
    live page outside the accepted positions untouched."""
    rng = np.random.default_rng(seed)
    pool0 = rng.normal(size=(npages, ps, 2, 3)).astype(np.float32)
    rows = rng.normal(size=(B, K, 2, 3)).astype(np.float32)
    pt = rng.permutation(np.arange(1, npages))[:B * T].reshape(B, T).astype(
        np.int32)
    lo = rng.integers(0, T * ps - K, B)
    pos0 = lo.astype(np.int32)
    n = rng.integers(0, K + 1, B).astype(np.int32)
    pool = torch.from_numpy(pool0.copy())
    out = tdec.commit_rows(pool, torch.from_numpy(rows),
                           torch.from_numpy(pos0), torch.from_numpy(n),
                           page_table=torch.from_numpy(pt))
    assert out is pool                                     # in place
    want = torch.from_numpy(pool0.copy())
    for j in range(K):
        pos_j = torch.from_numpy(np.where(j < n, pos0 + j, T * ps).astype(
            np.int32))
        tdec._paged_write(want, torch.from_numpy(rows[:, j]),
                          torch.from_numpy(pt), pos_j)
    assert torch.equal(pool, want)                         # bit-identical
    jgot = _jcommit(0, True)(pool0, rows, pos0, n, pt)
    assert np.array_equal(pool.numpy(), np.asarray(jgot))
    touched = {(int(pt[b, (lo[b] + j) // ps]), (lo[b] + j) % ps)
               for b in range(B) for j in range(int(n[b]))}
    for pg in range(1, npages):
        for off in range(ps):
            if (pg, off) not in touched:
                assert np.array_equal(pool[pg, off].numpy(),
                                      pool0[pg, off]), (pg, off)


@given(st.integers(min_value=0, max_value=10_000))
@settings(max_examples=25, deadline=None)
def test_commit_rows_property(seed):
    _commit_case(seed)


def test_commit_rows_fixed_seeds():
    """Always-running slice of the commit property: n = 0, n = K and
    page-straddling accepted prefixes."""
    for seed in range(8):
        _commit_case(seed)


def _ring_case(seed, B=2, K=3, S=8, W=8):
    rng = np.random.default_rng(seed)
    cache0 = rng.normal(size=(B, S, 2, 3)).astype(np.float32)
    rows = rng.normal(size=(B, K, 2, 3)).astype(np.float32)
    pos0 = rng.integers(0, 40, B).astype(np.int32)
    n = rng.integers(0, K + 1, B).astype(np.int32)
    cache = torch.from_numpy(cache0.copy())
    tdec.commit_rows(cache, torch.from_numpy(rows), torch.from_numpy(pos0),
                     torch.from_numpy(n), window=W)
    want = cache0.copy()
    for b in range(B):
        for j in range(int(n[b])):
            want[b, (int(pos0[b]) + j) % W] = rows[b, j]
    assert np.array_equal(cache.numpy(), want)
    jgot = _jcommit(W, False)(cache0, rows, pos0, n)
    assert np.array_equal(cache.numpy(), np.asarray(jgot))


def test_commit_rows_dense_ring():
    """Dense windowed leaves: the multi-row commit lands row j at ring slot
    (pos0+j) % window as the serial loop's single writes do (the second
    slot wraps), and as JAX's."""
    B, K, S, W = 2, 3, 8, 8
    rng = np.random.default_rng(2)
    cache0 = rng.normal(size=(B, S, 2, 3)).astype(np.float32)
    rows = rng.normal(size=(B, K, 2, 3)).astype(np.float32)
    cache = torch.from_numpy(cache0.copy())
    tdec.commit_rows(cache, torch.from_numpy(rows),
                     torch.tensor([6, 30], dtype=torch.int32),
                     torch.tensor([3, 2], dtype=torch.int32), window=W)
    want = cache0.copy()
    for b, (p0, n) in enumerate(((6, 3), (30, 2))):
        for j in range(n):
            want[b, (p0 + j) % W] = rows[b, j]
    assert np.array_equal(cache.numpy(), want)


@given(st.integers(min_value=0, max_value=10_000))
@settings(max_examples=25, deadline=None)
def test_commit_rows_ring_property(seed):
    _ring_case(seed)


# ----------------------------------------------------------- nucleus (top-p)
def test_top_p_one_is_stream_identical():
    """top_p = 1.0 and the 0.0 default draw the same tokens (the nucleus
    filter adds no change to the law), in the sampler and through a
    sampled speculative engine; a real nucleus changes the draws."""
    lg = torch.from_numpy(np.random.default_rng(0).normal(
        size=(64, 16)).astype(np.float32))

    def draws(top_p):
        return tdec._sample_tokens(lg, torch.Generator().manual_seed(0),
                                   temperature=0.8, top_k=4, top_p=top_p)
    assert torch.equal(draws(1.0), draws(0.0))
    assert not torch.equal(draws(0.3), draws(0.0))
    _, tp = _params(DRAFT)
    cfg = _tcfg(DRAFT)
    dcfg, dp = draft_from_target(cfg, tp, 1)
    prompts = _prompts(cfg.vocab, lens=(5, 9))

    def serve(top_p):
        return _serve(cfg, tp, prompts, max_new=8, draft_cfg=dcfg,
                      draft_params=dp, spec_k=3, temperature=0.9,
                      sample_seed=1, top_p=top_p)[1]
    assert serve(1.0) == serve(0.0)


def test_top_p_truncates_tail():
    """With p = [0.6, 0.3, 0.08, 0.02]: top_p=0.5 keeps {0}, 0.7 keeps
    {0,1}, 0.91 keeps {0,1,2}; outside-nucleus tokens are never sampled,
    inside ones are."""
    probs = np.array([0.6, 0.3, 0.08, 0.02])
    logits = torch.from_numpy(np.log(probs)).float()[None].expand(300, -1)

    def draws(top_p):
        return set(tdec._sample_tokens(
            logits, torch.Generator().manual_seed(1), temperature=1.0,
            top_k=0, top_p=top_p).tolist())
    assert draws(0.5) == {0}
    assert draws(0.7) == {0, 1}
    assert {0, 1} <= draws(0.91) <= {0, 1, 2}
    assert draws(1.0) >= {0, 1, 2}
    lg = tdec._filter_logits(logits[:1], temperature=1.0, top_k=0,
                             top_p=0.89)
    assert (torch.exp(lg)[0] > 0).tolist() == [True, True, False, False]


def test_top_p_engine_plumbing():
    """``Engine(top_p=...)`` reaches the device sampler of a speculative
    engine: top_p=1.0 reproduces the plain sampled stream, a tiny top_p
    collapses to greedy."""
    _, tp = _params(DRAFT)
    cfg = _tcfg(DRAFT)
    dcfg, dp = draft_from_target(cfg, tp, 1)
    prompts = _prompts(cfg.vocab, lens=(5, 9))

    def serve(**kw):
        return _serve(cfg, tp, prompts, max_new=6, draft_cfg=dcfg,
                      draft_params=dp, spec_k=3, **kw)[1]
    base = serve(temperature=0.9, sample_seed=1)
    assert serve(temperature=0.9, sample_seed=1, top_p=1.0) == base
    assert serve(temperature=0.9, sample_seed=1, top_p=1e-6) == serve()
    with pytest.raises(ValueError):
        Engine(cfg, tp, device="cpu", top_p=1.5, draft_cfg=dcfg,
               draft_params=dp, spec_k=3)


# --------------------------------------------------- throughput accounting
def test_multi_token_accounting_not_inflated():
    """StepReport.decoded and the tracker count emissions: with a random
    draft the target rejects, a spec_k=3 engine reports about one token a
    slot-round, not 4; decoded equals the tokens that reached the
    requests."""
    _, tp = _params(DRAFT)
    cfg = _tcfg(DRAFT)
    dcfg = dataclasses.replace(cfg, name="rand-draft")
    dp = _params(DRAFT, 11)[1]
    eng = Engine(cfg, tp, device="cpu", **ENGINE, draft_cfg=dcfg,
                 draft_params=dp, spec_k=3)
    reqs = [Request(rid=i, prompt=p, max_new=6)
            for i, p in enumerate(_prompts(cfg.vocab))]
    decoded = accepted = proposed = 0
    for r in reqs:
        eng.submit(r)
    while eng.has_work():
        rep = eng.step()
        assert rep.accepted <= rep.proposed
        decoded += rep.decoded
        accepted += rep.accepted
        proposed += rep.proposed
    emitted = sum(len(r.out) for r in reqs)
    assert decoded == emitted - len(reqs)       # first tokens at prefill
    rounds = proposed // eng.spec_k
    assert decoded <= accepted + rounds         # ≤ one correction a round
    assert (eng.spec_accepted, eng.spec_proposed) == (accepted, proposed)
    assert eng.tracker.snapshot()["decode"].iters_done <= decoded


# -------------------------------------------------- sampled spec statistics
def test_sampled_spec_matches_target_distribution():
    """Sampled speculative decode preserves the target's law: the
    frequencies of out[1] (the first token the decode loop emits) under
    top-k 16, against a plain run, within max(0.15, 2 x) the total
    variation of two plain runs of different seeds (the noise floor)."""
    _, tp = _params(DRAFT)
    cfg = _tcfg(DRAFT)
    dcfg, dp = draft_from_target(cfg, tp, 1)
    prompt = _prompts(cfg.vocab, lens=(6,))[0]
    N, B = 384, 16

    def freqs(sample_seed, **kw):
        eng = Engine(cfg, tp, device="cpu", max_slots=B, max_len=32,
                     decode_quantum=2, temperature=1.0, top_k=16,
                     sample_seed=sample_seed, paged=False, **kw)
        reqs = [Request(rid=i, prompt=list(prompt), max_new=2)
                for i in range(N)]
        eng.run(reqs)
        counts = np.zeros(cfg.vocab)
        for r in reqs:
            counts[r.out[1]] += 1
        return counts / N

    def tv(a, b):
        return 0.5 * np.abs(a - b).sum()

    f_plain = freqs(9)
    f_null = freqs(123)
    f_spec = freqs(77, draft_cfg=dcfg, draft_params=dp, spec_k=2)
    noise, dist = tv(f_plain, f_null), tv(f_plain, f_spec)
    assert dist < max(0.15, 2.0 * noise), (dist, noise)


# ------------------------------------------------ verify and commit, module
def _mid_state(cfg, paged, B=3, T=8, ps=8, seed=0):
    """A random mid-decode cache (pools beside rings and Mamba-2 states, or
    the dense engine's rows), a page table of distinct pages, and
    positions pos0 with room for K=4 rows: one at 3, one past the smoke
    window (a ring wraps), one near max_len."""
    rng = np.random.default_rng(seed)
    max_len = T * ps
    defs = (paged_cache_defs(cfg, num_pages=1 + B * T, page_size=ps,
                             max_slots=B, max_len=max_len) if paged else
            cache_defs(cfg, max_slots=B, max_len=max_len))
    cache = make_cache(defs, "cpu")
    for layer in cache["layers"]:
        for t in layer.values():
            t.copy_(torch.from_numpy(rng.normal(size=t.shape) * 0.5))
    pt = torch.from_numpy((1 + rng.permutation(B * T).reshape(B, T)).astype(
        np.int32)) if paged else None
    pos0 = torch.tensor([3, 37, max_len - 6], dtype=torch.int32)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (B, 4)).astype(
        np.int32))
    return cache, pt, pos0, toks


def _clone(cache):
    return tree_map(lambda t: t.clone(), cache)


def _to_jax(cfg, cache):
    """The port's per-layer cache as the JAX package's stacked ``blocks``."""
    layers, blocks, i = cache["layers"], [], 0
    for seg in layer_schedule(cfg):
        seg_tree = {}
        for j in range(len(seg.pattern)):
            ls = [layers[i + r * len(seg.pattern) + j]
                  for r in range(seg.repeat)]
            seg_tree[f"s{j}"] = {n: jnp.asarray(np.stack(
                [l[n].numpy() for l in ls])) for n in ls[0]}
        blocks.append(seg_tree)
        i += seg.repeat * len(seg.pattern)
    return {"blocks": blocks}


def _slot_view(cache, pt, b):
    """The rows of slot b in every leaf: its pages of a pool, its row of a
    dense leaf (rings, Mamba-2 state)."""
    out = []
    for layer in cache["layers"]:
        for t in layer.values():
            dense = pt is None or t.shape[0] != pt.numel() + 1
            out.append(t[b] if dense else t[pt[b].long()])
    return out


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("arch", ARCHS)
def test_verify_and_commit_match_serial_steps(arch, paged):
    """``decode_verify`` on K=4 tokens from a mid-decode state gives K
    serial ``decode_step``s' logits and JAX's ``decode_verify``'s (the
    cache untouched), and ``decode_commit(n)`` leaves each slot as n serial
    steps do: K/V rows in pages, dense rows and rings (gemma2: a slot past
    the window), Mamba-2 states."""
    jp, tp = _params(arch)
    cfg = _tcfg(arch)
    cache, pt, pos0, toks = _mid_state(cfg, paged)
    K = toks.shape[1]
    before = _clone(cache)
    logits, staged = tdec.decode_verify(cfg, tp, cache, toks, pos0, pt)
    assert logits.shape == (3, K, cfg.vocab) and logits.dtype == torch.float32
    for a, b in zip(tree_leaves(cache), tree_leaves(before)):
        assert torch.equal(a, b)                          # read-only
    serial, after = [], []
    c = _clone(cache)
    for j in range(K):
        lj, c = tdec.decode_step(cfg, tp, c, toks[:, j], pos0 + j, pt)
        serial.append(lj)
        after.append(_clone(c))
    np.testing.assert_allclose(logits.numpy(), torch.stack(serial, 1).numpy(),
                               rtol=TOL, atol=TOL)
    jlogits, _ = jdec.decode_verify(
        _jcfg(arch), jp, _to_jax(cfg, before), jnp.asarray(toks.numpy()),
        jnp.asarray(pos0.numpy()), single_device_ctx(),
        page_table=None if pt is None else jnp.asarray(pt.numpy()))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               rtol=TOL, atol=TOL)
    n = torch.tensor([0, K, 2], dtype=torch.int32)
    leaves = tree_leaves(cache)
    tdec.decode_commit(cfg, cache, staged, pos0, n, pt)
    assert all(a is b for a, b in zip(tree_leaves(cache), leaves))
    for b in range(3):
        want = before if int(n[b]) == 0 else after[int(n[b]) - 1]
        for got, ref in zip(_slot_view(cache, pt, b), _slot_view(want, pt, b)):
            np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-5,
                                       atol=1e-5)


# ------------------------------------------------- the speculative quantum
def _draft_state(dcfg, B, max_len, seed=1):
    rng = np.random.default_rng(seed)
    cache = make_cache(cache_defs(dcfg, max_slots=B, max_len=max_len), "cpu")
    for t in tree_leaves(cache):
        t.copy_(torch.from_numpy(rng.normal(size=t.shape) * 0.5))
    return cache


@pytest.mark.parametrize("sampling", ["greedy", "sampled"])
@pytest.mark.parametrize("arch", ARCHS)
def test_spec_quantum_matches_loop(arch, sampling):
    """``spec_decode_quantum`` in place equals ``spec_decode_loop`` bit for
    bit on a paged mid-decode state: the packed result, the slot state, the
    target's pools, rings and Mamba-2 states and the draft's rows, no leaf
    rebound."""
    _, tp = _params(arch)
    (_, _), _, (dcfg, dp) = _pair(arch)
    cfg = _tcfg(arch)
    cache, pt, pos0, _ = _mid_state(cfg, True)
    dcache = _draft_state(dcfg, 3, 64)
    slots = dict(tokens=torch.tensor([5, 9, 11], dtype=torch.int32), pos=pos0,
                 active=torch.tensor([True, True, False]),
                 remaining=torch.tensor([9, 3, 4], dtype=torch.int32))
    kw = dict(spec_k=3, num_steps=2, eos_id=-1, max_len=64,
              **(SAMPLED if sampling == "sampled" else {}))
    rc, rd = _clone(cache), _clone(dcache)
    carry, toks, msks, acc = tdec.spec_decode_loop(
        cfg, dcfg, tp, dp, rc, rd, *(t.clone() for t in slots.values()),
        page_table=pt, generator=torch.Generator().manual_seed(3), **kw)
    leaves = tree_leaves((cache, dcache))
    packed = torch.full((2 * 2 * 4 + 2 + 1, 3), -7, dtype=torch.int32)
    tdec.spec_decode_quantum(cfg, dcfg, tp, dp, cache, dcache,
                             *slots.values(), pt, packed,
                             generator=torch.Generator().manual_seed(3), **kw)
    assert torch.equal(packed, tdec._pack_spec(carry[4], toks, msks, acc))
    for name, want in zip(slots, carry[2:]):
        assert torch.equal(slots[name], want), name
    for a, b in zip(tree_leaves((cache, dcache)), tree_leaves(carry[:2])):
        assert torch.equal(a, b)
    assert all(a is b for a, b in zip(tree_leaves((cache, dcache)), leaves))
    assert int(packed[8:16, :2].sum()) >= 2       # the active slots emitted
    assert not packed[8:16, 2].any()              # the inactive one did not


class _Access(TorchDispatchMode):
    """The storages a run reads and writes from outside (made by no earlier
    op of the run); a constant made with ``torch.tensor`` enters through
    ``lift_fresh`` and is not from outside."""

    def __init__(self):
        super().__init__()
        self.made, self.read, self.written = set(), set(), set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is not torch.ops.aten.lift_fresh.default:
            outside = {}
            for t in tree_leaves((args, kwargs)):
                if isinstance(t, torch.Tensor):
                    p = t.untyped_storage().data_ptr()
                    if p and p not in self.made:
                        outside[id(t)] = p
            self.read |= set(outside.values())
            schema = func._schema.arguments
            for a, v in zip(schema, args):
                if a.alias_info is not None and a.alias_info.is_write and \
                        isinstance(v, torch.Tensor) and id(v) in outside:
                    self.written.add(outside[id(v)])
            for a in schema:
                v = kwargs.get(a.name)
                if a.alias_info is not None and a.alias_info.is_write and \
                        isinstance(v, torch.Tensor) and id(v) in outside:
                    self.written.add(outside[id(v)])
        out = func(*args, **kwargs)
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                p = t.untyped_storage().data_ptr()
                if p not in self.read:
                    self.made.add(p)
        return out


def _ptrs(tree):
    return {t.untyped_storage().data_ptr() for t in tree_leaves(tree)
            if isinstance(t, torch.Tensor)}


@pytest.mark.parametrize("arch,paged", [("mistral-nemo-12b", True),
                                        ("gemma2-2b", True),
                                        ("mamba2-130m", True),
                                        ("deepseek-v2-236b", False)])
def test_engine_standin_graphs_spec_match_jax(arch, paged, monkeypatch):
    """A speculative engine through the CPU stand-in of its CUDA graphs
    (``tests/test_torch_decode_graph.py``: a replay must read the storage
    its capture read) gives the JAX fast engine's spec streams; one
    capture per live width, every other quantum a replay; the capture
    reads only the engine's parameters, cache, draft cache, slot state,
    page table and result buffer, and writes only the cache, the draft
    cache, the slot state and the result buffer."""
    (jp, tp), (jdcfg, jdp), (dcfg, dp) = _pair(arch)
    cfg = _tcfg(arch)
    prompts = _prompts(cfg.vocab, lens=(4, 9, 17, 30, 45))
    kw = dict(max_slots=3, max_len=128, decode_quantum=3, paged=paged,
              page_size=4)
    jeng = JEngine(_jcfg(arch), jp, single_device_ctx(), draft_cfg=jdcfg,
                   draft_params=jdp, spec_k=3,
                   **{k: v for k, v in kw.items()
                      if paged or k not in ("paged", "page_size")})
    monkeypatch.setattr(jeng.tracker, "f", lambda: PINNED_F)
    jreqs = [JRequest(rid=i, prompt=p, max_new=16)
             for i, p in enumerate(prompts)]
    jeng.run(jreqs)
    eng = Engine(cfg, tp, device="cpu", draft_cfg=dcfg, draft_params=dp,
                 spec_k=3, **kw)
    eng.tracker.f = lambda: PINNED_F
    eng.graphs = StandInGraphs(eng.device, eng._gen)
    access = []
    capture = eng.graphs._capture

    def watched(fn):                     # the stand-in's one real run
        mode = _Access()
        with mode:
            entry = capture(fn)
        access.append((mode.read, mode.written))
        return entry
    eng.graphs._capture = watched
    reqs = [Request(rid=i, prompt=p, max_new=16)
            for i, p in enumerate(prompts)]
    eng.run(reqs)
    assert [r.out for r in reqs] == [r.out for r in jreqs]
    widths = set(eng.widths_used)
    assert eng.decode_captures == len(widths) == len(access)
    if "paged" in eng.kinds:
        assert len(widths) > 1
    replays = sum(g.replays for g, _ in eng.graphs._graphs.values())
    assert replays == eng.quanta - eng.decode_captures > 0
    state = (eng.cache, eng.draft_cache, eng.tokens_dev, eng.pos_dev,
             eng.active_dev, eng.remaining_dev, eng._packed)
    writable = _ptrs(state)
    readable = writable | _ptrs((eng.params, eng.draft_params,
                                 list(eng._tables.values()) if eng.paged
                                 else []))
    for read, written in access:
        assert read <= readable
        assert written <= writable
        assert _ptrs(eng.draft_cache) <= written
        assert _ptrs((eng._packed, eng.pos_dev)) <= written


# --------------------------------------------------------- draft models
def test_draft_from_target_and_soften():
    """``draft_from_target`` shares the target's tensors (its first n
    layers, embed, final norm, unembed) and refuses bad depths and
    non-uniform stacks; ``soften_deep_layers`` scales ``wo`` and ``w_down``
    of the deep layers as JAX's does and leaves its input unchanged."""
    from repro.models.draft import soften_deep_layers as jsoften
    jp, tp = _params(DRAFT)
    cfg = _tcfg(DRAFT)
    dcfg, dp = draft_from_target(cfg, tp, 1)
    assert dcfg.n_layers == 1 and dcfg.vocab == cfg.vocab
    assert dp["layers"][0] is tp["layers"][0]
    assert dp["embed"] is tp["embed"] and dp["unembed"] is tp["unembed"]
    for bad in (0, cfg.n_layers):
        with pytest.raises(ValueError, match="n_layers"):
            draft_from_target(cfg, tp, bad)
    ds = _tcfg("deepseek-v2-236b")        # a dense first layer, then MoE
    with pytest.raises(ValueError, match="uniform"):
        draft_from_target(ds, _params("deepseek-v2-236b")[1], 1)
    snap = [t.clone() for t in tree_leaves(tp)]
    soft = soften_deep_layers(cfg, tp, 1, 0.2)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(tp), snap))
    want = params_from_numpy(jax.tree.map(np.asarray,
                                          jsoften(_jcfg(DRAFT), jp, 1, 0.2)),
                             cfg, device="cpu")
    for a, b in zip(tree_leaves(soft), tree_leaves(want)):
        assert torch.equal(a, b)
    assert soft["layers"][0] is tp["layers"][0]
    assert not torch.equal(soft["layers"][1]["attn"]["wo"],
                           tp["layers"][1]["attn"]["wo"])
    assert soft["layers"][1]["attn"]["wq"] is tp["layers"][1]["attn"]["wq"]
    with pytest.raises(ValueError, match="n_keep"):
        soften_deep_layers(cfg, tp, 0)


def test_engine_spec_validation():
    """The engine refuses what the JAX engine refuses: spec_k without a
    draft, spec_k < 1, a vocab mismatch, a windowed or Mamba draft, spec_k
    + 1 past the target's smallest window; and draft params off the
    engine's device. Without draft params it makes them from seed 0."""
    _, tp = _params(DRAFT)
    cfg = _tcfg(DRAFT)
    dcfg, dp = draft_from_target(cfg, tp, 1)
    base = dict(device="cpu", max_slots=2, max_len=64)
    cases = [(dict(spec_k=3), "requires a draft_cfg"),
             (dict(draft_cfg=dcfg, draft_params=dp, spec_k=0), "spec_k"),
             (dict(draft_cfg=dataclasses.replace(dcfg, vocab=256),
                   spec_k=2), "vocab"),
             (dict(draft_cfg=dataclasses.replace(dcfg, sliding_window=16),
                   spec_k=2), "full-attention"),
             (dict(draft_cfg=dataclasses.replace(
                 _tcfg("mamba2-130m"), vocab=cfg.vocab), spec_k=2),
              "full-attention")]
    for kw, match in cases:
        with pytest.raises(ValueError, match=match):
            Engine(cfg, tp, **base, **kw)
    gcfg = _tcfg("gemma2-2b")
    with pytest.raises(ValueError, match="window"):
        Engine(gcfg, _params("gemma2-2b")[1], **base, draft_cfg=dcfg,
               draft_params=dp, spec_k=32)
    meta = tree_map(lambda t: t.to("meta"), dp)
    with pytest.raises(ValueError, match="draft params"):
        Engine(cfg, tp, **base, draft_cfg=dcfg, draft_params=meta, spec_k=2)
    eng = Engine(cfg, tp, **base, draft_cfg=dcfg, spec_k=2)
    want = init_params(dcfg, seed=0, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(
        tree_leaves(eng.draft_params), tree_leaves(want)))
    assert eng._packed.shape == (2 * 8 * 3 + 8 + 1, 2)
