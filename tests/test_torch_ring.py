"""Sliding-window rings, sandwich post-norm and the dense engine of the port
against the JAX package on the CPU: the ring packs and the per-slot write,
the dense and ring branches of decode attention, decoding past the window
against a full forward, bucketed prefill against exact-length prefill,
gemma2-2b's prefill and decode (post-norm, both softcaps, tied and scaled
embeddings), the engines' greedy streams against the JAX fast engine, and
post-norm training against ``jax.value_and_grad(loss_fn)``. Parameters
come from the JAX initializer, inputs from numpy seeds."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import all_configs, smoke_config
from repro.models.model import loss_fn as jloss_fn
from repro.models.model import model_defs
from repro.serve import decode as jdec
from repro.serve import prefill as jpre
from repro.serve.engine import Request as JRequest
from repro.serve.engine import make_engine as jmake_engine
from repro.sharding import params as prm
from repro_torch import configs as tconfigs
from repro_torch.models.layers import logits_fn
from repro_torch.models.model import loss_fn
from repro_torch.models.transformer import lm_hidden
from repro_torch.params import (n_params, param_specs, params_from_numpy,
                                tree_leaves)
from repro_torch.serve import decode as tdec
from repro_torch.serve import engine as teng
from repro_torch.serve import prefill as tpre
from repro_torch.train.step import make_state
# the JAX oracles compile at XLA's lowest optimization level (most of
# their time is compiling; f32 results agree to rounding)
from test_torch_variants import _jit

ATOL = 1e-4              # f32, as tests/test_torch_serve.py
REL = 3e-2               # bf16, and decode against a full forward (test_serve)
GRAD_TOL = {"float32": 1e-4, "bfloat16": 3e-2}
LOSS_TOL = {"float32": 1e-5, "bfloat16": 1e-3}
DANUBE, GEMMA = "h2o-danube-1.8b", "gemma2-2b"
# the MoE engines admit with one pinned HBB speed ratio (capacity couples
# the rows of a prefill group, as tests/test_torch_moe.py)
PINNED_F = 0.01


def _cfgs(arch, dtype="float32"):
    j = dataclasses.replace(smoke_config(all_configs()[arch]),
                            param_dtype=dtype)
    t = dataclasses.replace(tconfigs.smoke_config(tconfigs.get_config(arch)),
                            param_dtype=dtype)
    return j, t


def _model(arch, dtype="float32"):
    jcfg, tcfg = _cfgs(arch, dtype)
    jp = prm.materialize(model_defs(jcfg), jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    return jcfg, tcfg, jp, tp


@pytest.fixture(scope="module")
def jax_decode(ctx):
    """JAX's ``decode_step`` jitted once per config and shared by the
    module's decode loops: unjitted, its shard_map compiles at every
    call."""
    steps = {}

    def step(jcfg, params, cache, tokens, pos):
        fn = steps.get(jcfg)
        if fn is None:
            fn = steps[jcfg] = _jit(
                lambda p, c, t, q: jdec.decode_step(jcfg, p, c, t, q, ctx))
        return fn(params, cache, tokens, pos)
    return step


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


# ------------------------------------------------------------ ring packs
@pytest.mark.parametrize("S,Sc", [(10, 16), (16, 16), (40, 16), (64, 32),
                                  (33, 32)])
def test_ring_pack_matches_jax(S, Sc):
    """JAX's tail pack of unpadded rows is the per-row pack at prompt_len
    S, the port's one packing."""
    k = np.random.default_rng(S).normal(size=(2, S, 3, 4)).astype(np.float32)
    got = tpre._ring_pack_pl(torch.from_numpy(k), Sc,
                             torch.full((2,), S, dtype=torch.int32))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jpre._ring_pack(jnp.asarray(k),
                                                             Sc)))


@pytest.mark.parametrize("S,Sc", [(16, 32), (32, 32), (64, 32), (128, 32),
                                  (64, 24)])
def test_ring_pack_pl_matches_jax(S, Sc):
    """Per-row packs of a padded bucket, also a bucket longer than the
    window (pads past the window must not wrap onto real positions): rows
    of 1 token, shorter than, equal to and longer than the ring, and the
    full bucket."""
    rng = np.random.default_rng(S + Sc)
    k = rng.normal(size=(5, S, 2, 8)).astype(np.float32)
    pl = np.array([1, min(S, Sc - 3), min(S, Sc), min(S, Sc + 5), S],
                  np.int32)
    got = tpre._ring_pack_pl(torch.from_numpy(k), Sc, torch.from_numpy(pl))
    want = jpre._ring_pack_pl(jnp.asarray(k), Sc, jnp.asarray(pl))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # slot j holds the last real position p ≡ j (mod Sc)
    row = int(np.argmax(pl > Sc)) if (pl > Sc).any() else None
    if row is not None:
        p = pl[row] - 1
        np.testing.assert_array_equal(got[row, p % Sc].numpy(), k[row, p])


def test_local_write_matches_jax():
    """Rows written in place at ``rel``; a ``rel`` outside the rows (a
    frozen slot of a full dense cache) writes nothing."""
    rng = np.random.default_rng(1)
    cache = rng.normal(size=(4, 8, 2, 3)).astype(np.float32)
    row = rng.normal(size=(4, 2, 3)).astype(np.float32)
    rel = np.array([0, 7, 8, -1], np.int32)
    t = torch.from_numpy(cache.copy())
    got = tdec._local_write(t, torch.from_numpy(row), torch.from_numpy(rel))
    assert got is t
    want = jdec._local_write(jnp.asarray(cache), jnp.asarray(row),
                             jnp.asarray(rel))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got[2].numpy(), cache[2])


# --------------------------------------------------- dense/ring decode
@pytest.mark.parametrize("window,softcap", [(0, 0.0), (16, 0.0), (16, 20.0),
                                            (24, 50.0)])
def test_dense_decode_attention_matches_jax(ctx, window, softcap):
    """The ring (window) and full dense branches of ``flash_decode_gqa``
    against JAX's local branch: the write at ``pos mod S`` (or ``pos``),
    live slots ``p_j > pos - window``, the softcap before the mask; slots
    before, at and far past a wrap of the ring, and a frozen slot."""
    rng = np.random.default_rng(window)
    B, S, hkv, G, dh = 5, 16 if window else 40, 2, 3, 8
    ck = rng.normal(size=(B, S, hkv, dh)).astype(np.float32)
    cv = rng.normal(size=(B, S, hkv, dh)).astype(np.float32)
    q = rng.normal(size=(B, hkv, G, dh)).astype(np.float32)
    kn = rng.normal(size=(B, hkv, dh)).astype(np.float32)
    vn = rng.normal(size=(B, hkv, dh)).astype(np.float32)
    pos = np.array([0, 5, S - 1, S + 3, 3 * S + 7 if window else S],
                   np.int32)
    kw = dict(scale=dh ** -0.5, softcap=softcap, window=window)
    tk, tv = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
    out, k2, v2 = tdec.flash_decode_gqa(
        torch.from_numpy(q), torch.from_numpy(kn), torch.from_numpy(vn), tk,
        tv, torch.from_numpy(pos), page_table=None,
        rows=tdec._dense_rows(torch.from_numpy(pos), S, window), **kw)
    assert k2 is tk and v2 is tv
    jout, jk, jv = jdec.flash_decode_gqa(
        *map(jnp.asarray, (q, kn, vn, ck, cv, pos)), ctx=ctx, **kw)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=ATOL,
                               atol=ATOL)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_dense_mla_decode_matches_jax(ctx):
    """The dense MLA branch (the dense engine's latent rows) against JAX."""
    rng = np.random.default_rng(2)
    B, S, H, R, lora = 3, 20, 4, 24, 16
    ckv = rng.normal(size=(B, S, R)).astype(np.float32)
    q = rng.normal(size=(B, H, R)).astype(np.float32)
    row = rng.normal(size=(B, R)).astype(np.float32)
    pos = np.array([0, 11, S], np.int32)                 # last: frozen slot
    t = torch.from_numpy(ckv.copy())
    out, c2 = tdec.flash_decode_mla(torch.from_numpy(q),
                                    torch.from_numpy(row), t,
                                    torch.from_numpy(pos), kv_lora=lora,
                                    scale=0.3, rows=tdec._dense_rows(
                                        torch.from_numpy(pos), S, 0))
    jout, jc = jdec.flash_decode_mla(*map(jnp.asarray, (q, row, ckv, pos)),
                                     kv_lora=lora, scale=0.3, ctx=ctx)
    assert c2 is t
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=ATOL,
                               atol=ATOL)
    np.testing.assert_array_equal(t.numpy(), np.asarray(jc))


# ------------------------------------------------- decode past the window
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sliding_window_ring_equivalence(ctx, jax_decode, dtype):
    """Decoding 12 steps past the window of 32 (danube smoke) equals the
    full forward of the same tokens (the ring overwrite is exact; 3e-2
    relative, as tests/test_serve.py), and each step's logits equal JAX's
    ring decode (f32 1e-4, bf16 3e-2 relative)."""
    jcfg, tcfg, jp, tp = _model(DANUBE, dtype)
    B, S, extra = 1, 40, 12
    toks = np.random.default_rng(1).integers(0, tcfg.vocab, (B, S + extra))
    toks = toks.astype(np.int32)
    _, cache = tpre.prefill(tcfg, tp, torch.from_numpy(toks[:, :S]),
                            max_len=96)
    _, jcache = jpre.prefill(jcfg, jp, jnp.asarray(toks[:, :S]), ctx,
                             max_len=96)
    assert cache["layers"][0]["k"].shape[1] == 32
    for t in range(extra):
        pos = np.full((B,), S + t, np.int32)
        logits, cache = tdec.decode_step(tcfg, tp, cache,
                                         torch.from_numpy(toks[:, S + t]),
                                         torch.from_numpy(pos))
        jlogits, jcache = jax_decode(jcfg, jp, jcache,
                                     jnp.asarray(toks[:, S + t]),
                                     jnp.asarray(pos))
        if dtype == "float32":
            np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                       rtol=ATOL, atol=ATOL)
        else:
            assert _rel(logits.numpy(), jlogits) < REL
    h, _ = lm_hidden(tcfg, tp, torch.from_numpy(toks))
    ref = logits_fn(tcfg, tp["embed"], tp["unembed"], h[:, -1])
    assert _rel(logits.numpy(), ref.detach().numpy()) < REL


@pytest.mark.parametrize("arch", [DANUBE, "mistral-nemo-12b",
                                  "deepseek-v2-236b"])
def test_bucketed_prefill_equivalence(arch):
    """Prefill padded to a bucket with explicit prompt_len equals
    exact-length prefill: the last-token logits (3e-2 relative, same
    argmax) and the 12 greedy tokens decoded onward, past danube's window
    (the ring-pack gather check), as tests/test_serve.py."""
    _, tcfg, _, tp = _model(arch, "bfloat16")
    B, S, Sb, max_len = 2, 21, 32, 64
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, tcfg.vocab, (B, S)).astype(np.int32))
    ref_logits, ref_cache = tpre.prefill(tcfg, tp, toks, max_len=max_len)
    padded = torch.cat([toks, toks.new_zeros((B, Sb - S))], dim=1)
    pl = torch.full((B,), S, dtype=torch.int32)
    logits, cache = tpre.prefill(tcfg, tp, padded, max_len=max_len,
                                 prompt_len=pl)
    assert _rel(logits.numpy(), ref_logits.numpy()) < REL
    assert torch.equal(logits.argmax(-1), ref_logits.argmax(-1))
    start = ref_logits.argmax(-1).to(torch.int32)
    args = (pl, torch.ones(B, dtype=torch.bool),
            torch.full((B,), 99, dtype=torch.int32))
    kw = dict(num_steps=12, eos_id=-1, max_len=max_len, page_table=None)
    _, ref_toks, _ = tdec.decode_loop(tcfg, tp, ref_cache, start.clone(),
                                      *(a.clone() for a in args), **kw)
    _, fast_toks, _ = tdec.decode_loop(tcfg, tp, cache, start.clone(),
                                       *(a.clone() for a in args), **kw)
    assert torch.equal(ref_toks, fast_toks)


# ------------------------------------------------------ gemma2 (post-norm)
def test_gemma2_param_tree():
    """Post-norm weights per layer, tied embeddings (no unembedding), the
    parameter count of the JAX tree at full width and at smoke size."""
    for cfg in (all_configs()[GEMMA], smoke_config(all_configs()[GEMMA])):
        tcfg = tconfigs.get_config(GEMMA)
        if "smoke" in cfg.name:
            tcfg = tconfigs.smoke_config(tcfg)
        specs = param_specs(tcfg)
        assert specs["unembed"] == {}
        assert all({"post1", "post2", "norm1", "norm2"} <= set(layer)
                   for layer in specs["layers"])
        assert n_params(tcfg) == prm.n_params(model_defs(cfg))
    assert n_params(tconfigs.get_config(GEMMA)) == 2_614_341_888


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gemma2_prefill_decode_match_jax(ctx, jax_decode, dtype):
    """gemma2 smoke (local window 32 and global layers, attention softcap 50
    and final softcap 30, post-norm, geglu, tied and sqrt(d)-scaled
    embeddings): bucketed prefill logits and every cache row (rings and
    full rows), then 12 dense decode steps past the window, against JAX
    (f32 1e-4; bf16 3e-2 relative)."""
    jcfg, tcfg, jp, tp = _model(GEMMA, dtype)
    assert tcfg.use_post_norm and tcfg.attn_softcap and tcfg.final_softcap
    rng = np.random.default_rng(4)
    lens = np.array([23, 48], np.int32)
    toks = np.zeros((2, 64), np.int32)
    for i, n in enumerate(lens):
        toks[i, :n] = rng.integers(0, tcfg.vocab, n)
    max_len = 96
    logits, cache = tpre.prefill(tcfg, tp, torch.from_numpy(toks),
                                 max_len=max_len,
                                 prompt_len=torch.from_numpy(lens))
    jlogits, jcache = jpre.prefill(jcfg, jp, jnp.asarray(toks), ctx,
                                   max_len=max_len,
                                   prompt_len=jnp.asarray(lens))
    f32 = dtype == "float32"
    if f32:
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   rtol=ATOL, atol=ATOL)
        flat = [jax.tree.map(lambda a, r=r: np.asarray(a)[r], s[f"s{j}"])
                for s in jcache["blocks"] for r in range(
                    next(iter(jax.tree.leaves(s))).shape[0])
                for j in range(len(s))]
        for layer, want in zip(cache["layers"], flat):
            for name in ("k", "v"):
                assert tuple(layer[name].shape) == want[name].shape
                np.testing.assert_allclose(layer[name].numpy(), want[name],
                                           rtol=ATOL, atol=ATOL)
    else:
        assert _rel(logits.numpy(), jlogits) < REL
    tok = logits.argmax(-1).to(torch.int32)
    pos = torch.from_numpy(lens.copy())
    for _ in range(12):
        logits, cache = tdec.decode_step(tcfg, tp, cache, tok, pos)
        jlogits, jcache = jax_decode(jcfg, jp, jcache,
                                     jnp.asarray(tok.numpy()),
                                     jnp.asarray(pos.numpy()))
        if f32:
            np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                       rtol=ATOL, atol=ATOL)
        else:
            assert _rel(logits.numpy(), jlogits) < REL
        tok = torch.from_numpy(np.asarray(jlogits).argmax(-1).astype(
            np.int32))
        pos = pos + 1
    assert int(pos.min()) > 32                  # past the window


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_post_norm_loss_and_grads_match_jax(ctx, dtype):
    """``block_apply`` with post-norm (gemma2 smoke, window and softcaps
    included): the loss and every gradient leaf against
    ``jax.value_and_grad(loss_fn)`` on ``materialize(model_defs(cfg))``."""
    jcfg, tcfg, jp, tp = _model(GEMMA, dtype)
    toks = np.random.default_rng(0).integers(0, jcfg.vocab, (4, 65))
    toks = toks.astype(np.int32)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:],
             "mask": np.ones((4, 64), np.float32)}
    (jloss, _), jg = _jit(jax.value_and_grad(
        lambda p, b: jloss_fn(jcfg, p, b, ctx), has_aux=True))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    tp = make_state(tp)["params"]
    loss, _ = loss_fn(tcfg, tp, {k: torch.from_numpy(v)
                                 for k, v in batch.items()})
    grads = torch.autograd.grad(loss, tree_leaves(tp))
    want = params_from_numpy(jax.tree.map(np.asarray, jg), tcfg,
                             device="cpu")
    assert abs(loss.item() - float(jloss)) <= LOSS_TOL[dtype] * float(jloss)
    for g, w in zip(grads, tree_leaves(want)):
        err = float((g.float() - w.float()).abs().max() /
                    w.float().abs().max())
        assert err < GRAD_TOL[dtype], (tuple(g.shape), err)


# ---------------------------------------------------------------- engines
ENGINES = [(DANUBE, False), (GEMMA, False), (GEMMA, True),
           ("mistral-nemo-12b", False), ("deepseek-v2-236b", False),
           ("mamba2-130m", False)]


@pytest.mark.parametrize("arch,paged", ENGINES,
                         ids=[f"{a}-{'paged' if p else 'dense'}"
                              for a, p in ENGINES])
def test_engine_greedy_streams_match_jax(ctx, arch, paged, monkeypatch):
    """The port's engine against the JAX fast engine of the same layout in
    f32: identical greedy streams, every slot decoding past the smoke
    window of 32 for the ring models; one host read per quantum and per
    prefill group; a paged engine's pool whole after the run, a dense
    engine with no page table."""
    jcfg, tcfg, jp, tp = _model(arch)
    rng = np.random.default_rng(3)
    lens = [4, 5, 9, 17, 18, 23, 63] if arch != "mamba2-130m" else \
        [5, 9, 17, 40]
    prompts = [rng.integers(0, tcfg.vocab, n).tolist() for n in lens]
    budget = [1 if i == 1 else 40 for i in range(len(lens))]
    kw = dict(max_slots=3, max_len=128, page_size=8, decode_quantum=4)
    jeng = jmake_engine(jcfg, ctx, paged=paged, **kw)
    monkeypatch.setattr(jeng.tracker, "f", lambda: PINNED_F)
    jreqs = [JRequest(rid=i, prompt=p, max_new=n)
             for i, (p, n) in enumerate(zip(prompts, budget))]
    jeng.run(jreqs)
    fetches = []
    orig = teng._host_fetch
    monkeypatch.setattr(teng, "_host_fetch",
                        lambda x: fetches.append(1) or orig(x))
    eng = teng.Engine(tcfg, tp, device="cpu", paged=paged, **kw)
    monkeypatch.setattr(eng.tracker, "f", lambda: PINNED_F)
    reqs = [teng.Request(rid=i, prompt=p, max_new=n)
            for i, (p, n) in enumerate(zip(prompts, budget))]
    eng.run(reqs)
    assert all(r.done for r in reqs)
    assert [r.out for r in reqs] == [r.out for r in jreqs], \
        [(a.out, b.out) for a, b in zip(jreqs, reqs)]
    assert len(fetches) == eng.quanta + eng.prefill_groups
    if paged:
        eng.alloc.check()
        assert len(eng.alloc.free) == eng.alloc.usable_pages
        assert eng.kinds.count("paged") == tcfg.n_layers // 2
    else:
        assert eng.alloc is None and eng.page_table_dev is None
        assert set(eng.widths_used) == {0} and "paged" not in eng.kinds
    if tcfg.sliding_window:
        assert all(len(p) + len(r.out) > 32 for p, r in zip(prompts, reqs)
                   if len(r.out) > 1)


def test_dense_engine_admission_has_no_page_budget(ctx):
    """The dense engine admits by free slots and the HBB budget alone: a
    paged engine of a one-context pool takes one request of three, the
    dense engine all three."""
    _, tcfg, _, tp = _model("mistral-nemo-12b")
    prompts = [list(range(1, 30)), list(range(2, 31)), list(range(3, 32))]
    reqs = [teng.Request(rid=i, prompt=p, max_new=20)
            for i, p in enumerate(prompts)]
    kw = dict(max_slots=3, max_len=64, page_size=8, decode_quantum=4)
    paged = teng.Engine(tcfg, tp, device="cpu", num_pages=9, **kw)
    dense = teng.Engine(tcfg, tp, device="cpu", paged=False, **kw)
    assert paged.plan_admission(reqs) == 1
    assert dense.plan_admission(reqs) == 3
    dense.run(reqs)
    assert all(r.done and len(r.out) == 20 for r in reqs)
    assert not dense.has_work() and dense.abort() == []
