"""Speculative decode with a Mamba-1 target: jamba-v0.1-52b's smoke config
(7 Mamba-1 layers, attention at slot 4, MoE on the odd slots) verified by
the port against the JAX package on the CPU, in f32.

A jamba target takes an independent draft (``draft_from_target`` refuses
hybrid schedules, as JAX's): mistral-nemo-12b's smoke config, which shares
the smoke vocab, as ``tests/test_spec_decode.py`` does. The JAX side runs
on a 1×1 mesh with Auto axes (on the default Explicit-axis mesh JAX's
hybrid raises a ``ShardingTypeError``). Prompts stay shorter than jamba
smoke's 32-token chunk: past a chunk JAX's Mamba-1 conv state is sliced
after the padding (``repro/models/mamba.py:320``) and is not an oracle.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._pytree import tree_leaves

from repro.configs import all_configs, smoke_config
from repro.models.model import model_defs
from repro.serve import decode as jdec
from repro.serve.engine import Engine as JEngine
from repro.serve.engine import Request as JRequest
from repro.sharding import params as prm
from repro_torch import configs as tconfigs
from repro_torch.params import init_params, params_from_numpy, tree_map
from repro_torch.serve import decode as tdec
from repro_torch.serve.engine import Engine, Request
from test_torch_decode_graph import StandInGraphs
from test_torch_jamba import _unstack, auto_ctx, jax_params  # noqa: F401
from test_torch_spec_decode import (_Access, _clone, _draft_state,
                                    _mid_state, _ptrs, _slot_view, _to_jax)

ARCH, DRAFT = "jamba-v0.1-52b", "mistral-nemo-12b"
TOL = 1e-4
PINNED_F = 0.01
LENS = (5, 11, 19, 27)          # each shorter than jamba smoke's chunk (32)


def _jcfg(arch):
    return dataclasses.replace(smoke_config(all_configs()[arch]),
                               param_dtype="float32")


def _tcfg(arch):
    return dataclasses.replace(tconfigs.smoke_config(
        tconfigs.get_config(arch)), param_dtype="float32")


@functools.cache
def _params(arch, seed=0):
    """Seeded port parameters (f32) and the same numbers as a JAX tree."""
    tp = init_params(_tcfg(arch), seed, device="cpu")
    return jax_params(_tcfg(arch), tp), tp


def _prompts(vocab, lens=LENS, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n).tolist() for n in lens]


def _serve(prompts, *, max_new=10, spec=True, **kw):
    eng = Engine(_tcfg(ARCH), _params(ARCH)[1], device="cpu", max_slots=2,
                 max_len=64, decode_quantum=3, **kw,
                 **(dict(draft_cfg=_tcfg(DRAFT), draft_params=_params(
                     DRAFT, 7)[1], spec_k=3) if spec else {}))
    eng.tracker.f = lambda: PINNED_F
    reqs = [Request(rid=i, prompt=p, max_new=max_new)
            for i, p in enumerate(prompts)]
    eng.run(reqs)
    assert all(r.done for r in reqs)
    return eng, [r.out for r in reqs]


def test_jax_params_invert_params_from_numpy():
    """:func:`jax_params` gives the JAX tree of ``model_defs`` (shapes and
    dtypes), and ``params_from_numpy`` carries it back to the same
    tensors."""
    jp, tp = _params(ARCH)
    defs = model_defs(_jcfg(ARCH))
    assert jax.tree.map(lambda d: (tuple(d.shape), np.dtype(d.dtype)), defs,
                        is_leaf=prm.is_def) == \
        jax.tree.map(lambda a: (a.shape, a.dtype), jp)
    back = params_from_numpy(jax.tree.map(np.asarray, jp), _tcfg(ARCH),
                             device="cpu")
    tree_map(lambda a, b: np.testing.assert_array_equal(a.numpy(),
                                                        b.numpy()), back, tp)


# ------------------------------------------------------------- streams
@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_greedy_spec_token_equivalence(paged):
    """JAX's ``test_greedy_spec_token_equivalence[jamba-v0.1-52b]``:
    draft-assisted greedy decode emits the target-only stream, dense and
    paged, and proposals were made (an independent random draft: mostly
    rejected, so the correction-only path runs)."""
    prompts = _prompts(_tcfg(ARCH).vocab)
    kw = dict(paged=paged, page_size=8)
    _, plain = _serve(prompts, spec=False, **kw)
    eng, spec = _serve(prompts, **kw)
    assert spec == plain
    assert eng.spec_proposed > 0
    if paged:
        eng.alloc.check()
        assert len(eng.alloc.free) == eng.alloc.usable_pages


# ------------------------------------------------------- verify / commit
@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_verify_and_staged_states_match_jax(paged, auto_ctx):
    """``decode_verify`` of K = 4 tokens from a random mid-decode state:
    logits and every staged leaf (the attention layer's K/V rows and each
    Mamba-1 layer's K conv tails and f32 SSM states) against JAX's
    ``decode_verify``; K serial ``decode_step``s give the same logits, and
    ``decode_commit(n)`` leaves each Mamba-1 slot in state n - 1 (n = 0:
    untouched) as n serial steps do."""
    jp, tp = _params(ARCH)
    cfg = _tcfg(ARCH)
    cache, pt, pos0, toks = _mid_state(cfg, paged)
    K = toks.shape[1]
    before = _clone(cache)
    logits, staged = tdec.decode_verify(cfg, tp, cache, toks, pos0, pt)
    for a, b in zip(tree_leaves(cache), tree_leaves(before)):
        assert torch.equal(a, b)                          # read-only
    jlogits, jstaged = jdec.decode_verify(
        _jcfg(ARCH), jp, _to_jax(cfg, before), jnp.asarray(toks.numpy()),
        jnp.asarray(pos0.numpy()), auto_ctx,
        page_table=None if pt is None else jnp.asarray(pt.numpy()))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               rtol=TOL, atol=TOL)
    mamba = 0
    for i, (layer, jlayer) in enumerate(zip(
            staged["layers"], _unstack(cfg, jstaged["blocks"]))):
        assert set(layer) == set(jlayer), i
        for name, t in layer.items():
            np.testing.assert_allclose(t.numpy(), jlayer[name], rtol=TOL,
                                       atol=TOL, err_msg=f"{i} {name}")
        if "ssm" in layer:
            mamba += 1
            assert layer["ssm"].shape == (K, 3, cfg.d_inner,
                                          cfg.ssm.d_state)
            assert layer["ssm"].dtype == torch.float32
    assert mamba == 7
    serial, after = [], []
    c = _clone(cache)
    for j in range(K):
        lj, c = tdec.decode_step(cfg, tp, c, toks[:, j], pos0 + j, pt)
        serial.append(lj)
        after.append(_clone(c))
    np.testing.assert_allclose(logits.numpy(), torch.stack(serial, 1).numpy(),
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


def test_spec_quantum_matches_loop():
    """``spec_decode_quantum`` in place equals ``spec_decode_loop`` bit for
    bit on a paged mid-decode jamba state: the packed result, the slot
    state, the pools and every Mamba-1 conv tail and SSM state, no leaf
    rebound."""
    _, tp = _params(ARCH)
    dcfg, dp = _tcfg(DRAFT), _params(DRAFT, 7)[1]
    cfg = _tcfg(ARCH)
    cache, pt, pos0, _ = _mid_state(cfg, True)
    dcache = _draft_state(dcfg, 3, 64)
    slots = dict(tokens=torch.tensor([5, 9, 11], dtype=torch.int32), pos=pos0,
                 active=torch.tensor([True, True, False]),
                 remaining=torch.tensor([9, 3, 4], dtype=torch.int32))
    kw = dict(spec_k=3, num_steps=2, eos_id=-1, max_len=64)
    rc, rd = _clone(cache), _clone(dcache)
    carry, toks, msks, acc = tdec.spec_decode_loop(
        cfg, dcfg, tp, dp, rc, rd, *(t.clone() for t in slots.values()),
        page_table=pt, **kw)
    leaves = tree_leaves((cache, dcache))
    packed = torch.full((2 * 2 * 4 + 2 + 1, 3), -7, dtype=torch.int32)
    tdec.spec_decode_quantum(cfg, dcfg, tp, dp, cache, dcache,
                             *slots.values(), pt, packed, **kw)
    assert torch.equal(packed, tdec._pack_spec(carry[4], toks, msks, acc))
    for name, want in zip(slots, carry[2:]):
        assert torch.equal(slots[name], want), name
    for a, b in zip(tree_leaves((cache, dcache)), tree_leaves(carry[:2])):
        assert torch.equal(a, b)
    assert all(a is b for a, b in zip(tree_leaves((cache, dcache)), leaves))
    ssm = [layer["ssm"] for layer in cache["layers"] if "ssm" in layer]
    assert len(ssm) == 7 and not torch.equal(ssm[0][0], rc["layers"][0][
        "ssm"][2])                          # an active slot's state moved


def test_engine_standin_graphs_spec_match_jax(auto_ctx, monkeypatch):
    """A speculative jamba engine through the CPU stand-in of its CUDA
    graphs (a replay must read the storage its capture read) gives the JAX
    fast engine's spec streams on the Auto-axis mesh; one capture per live
    width; the capture reads only the engine's parameters, caches, slot
    state, page tables and result buffer and writes only the caches (the
    Mamba-1 states among them), the slot state and the result buffer."""
    (jp, tp), cfg = _params(ARCH), _tcfg(ARCH)
    (jdp, dp), dcfg = _params(DRAFT, 7), _tcfg(DRAFT)
    prompts = _prompts(cfg.vocab, lens=(13, 13))    # one prefill group
    kw = dict(max_slots=2, max_len=64, decode_quantum=3, paged=True,
              page_size=4)
    jeng = JEngine(_jcfg(ARCH), jp, auto_ctx, draft_cfg=_jcfg(DRAFT),
                   draft_params=jdp, spec_k=3, **kw)
    monkeypatch.setattr(jeng.tracker, "f", lambda: PINNED_F)
    jreqs = [JRequest(rid=i, prompt=p, max_new=14)
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
    reqs = [Request(rid=i, prompt=p, max_new=14)
            for i, p in enumerate(prompts)]
    eng.run(reqs)
    assert [r.out for r in reqs] == [r.out for r in jreqs]
    assert eng.decode_captures == len(set(eng.widths_used)) == len(access)
    assert len(set(eng.widths_used)) == 2                   # 8 and 16 pages
    replays = sum(g.replays for g, _ in eng.graphs._graphs.values())
    assert replays == eng.quanta - eng.decode_captures > 0
    state = (eng.cache, eng.draft_cache, eng.tokens_dev, eng.pos_dev,
             eng.active_dev, eng.remaining_dev, eng._packed)
    writable = _ptrs(state)
    readable = writable | _ptrs((eng.params, eng.draft_params,
                                 list(eng._tables.values())))
    ssm = _ptrs([layer["ssm"] for layer in eng.cache["layers"]
                 if "ssm" in layer])
    for read, written in access:
        assert read <= readable
        assert written <= writable
        assert ssm <= written
