"""Mamba-2 serving in the port against the JAX package on the CPU, at the
mamba2-130m smoke config (2 layers, d 64, d_inner 128, N 16, chunk 32):
the SSD intra-chunk's plain version against the Pallas kernel in
interpret mode, the mixer's functions, prefill → decode continuity, and
greedy streams of the paged engine against the JAX fast paged engine.
Parameters come from the JAX initializer, inputs from numpy seeds."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import all_configs, smoke_config
from repro.kernels.ssd.ssd import ssd_intra_chunk
from repro.models import mamba as jm
from repro.models.model import model_defs
from repro.serve.engine import Request as JRequest
from repro.serve.engine import make_engine as jmake_engine
from repro.sharding import params as prm
from repro.sharding.axes import single_device_ctx
from repro_torch import configs as tconfigs
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.kernels.ssd import ref as ssd_ref
from repro_torch.models import mamba as tm
from repro_torch.models import transformer as ttr
from repro_torch.params import (init_params, n_params, params_from_numpy,
                                tree_map)
from repro_torch.serve import engine as teng
from repro_torch.serve.decode import decode_step
from repro_torch.serve.kv_cache import cache_kinds, paged_cache_defs
from repro_torch.serve.prefill import prefill

ARCH = "mamba2-130m"
SSD_TOL = 1e-5           # tests/test_kernels.py::test_ssd_kernel_sweep
SCAN_TOL = 1e-3          # tests/test_mamba.py::test_ssd_scan_matches_naive
MIXER_TOL = 5e-3         # tests/test_mamba.py full-vs-step / continuation
ATOL = 1e-4              # f32 logits, as tests/test_torch_serve.py


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=tol, atol=tol)


@pytest.fixture(scope="module")
def model():
    jcfg = dataclasses.replace(smoke_config(all_configs()[ARCH]),
                               param_dtype="float32")
    tcfg = dataclasses.replace(tconfigs.smoke_config(
        tconfigs.get_config(ARCH)), param_dtype="float32")
    jp = prm.materialize(model_defs(jcfg), jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    return jcfg, tcfg, jp, tp


def test_config_and_params_match_jax(model):
    jcfg, tcfg, jp, tp = model
    full_j, full_t = all_configs()[ARCH], tconfigs.get_config(ARCH)
    assert dataclasses.asdict(full_t.ssm) == dataclasses.asdict(full_j.ssm)
    assert full_t.ssm.chunk == 256 and full_t.d_inner == full_j.d_inner
    assert n_params(full_t) == prm.n_params(model_defs(full_j))
    assert n_params(tcfg) == prm.n_params(model_defs(jcfg))
    assert tp["unembed"] == {} and tcfg.tie_embeddings
    m = tp["layers"][0]["mamba"]
    for name in ("A_log", "D_skip", "dt_bias", "gn"):
        assert m[name].dtype == torch.float32
    bf = dataclasses.replace(tcfg, param_dtype="bfloat16")
    p = init_params(bf, device="cpu")["layers"][1]["mamba"]
    assert p["wz"].dtype == torch.bfloat16 and p["A_log"].dtype == \
        torch.float32
    assert torch.equal(p["A_log"], torch.zeros_like(p["A_log"]))
    assert torch.equal(p["D_skip"], torch.ones_like(p["D_skip"]))


# ---------------------------------------------------------------- kernel
def _ssd_inputs(G, Q, P, N, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(G, Q, P)).astype(np.float32)
    cs = np.cumsum(-np.log1p(np.exp(rng.normal(size=(G, Q, 1)))), axis=1)
    B = rng.normal(size=(G, Q, N)).astype(np.float32)
    C = rng.normal(size=(G, Q, N)).astype(np.float32)
    return x, cs.astype(np.float32), B, C


@pytest.mark.parametrize("Q,P,N", [(32, 16, 32), (64, 64, 128),
                                   (40, 16, 32)])
def test_ssd_plain_matches_pallas_interpret(Q, P, N):
    """test_kernels.py::test_ssd_kernel_sweep's (Q, P, N), plus a ragged Q:
    the TPU contract's G as (G, 1) heads."""
    x, cs, B, C = _ssd_inputs(4, Q, P, N)
    y, st = ssd_intra_chunk(*map(jnp.asarray, (x, cs, B, C)), interpret=True)
    ty, tst = ssd_ops.intra_chunk(_t(x)[:, None], _t(cs)[:, None, :, 0],
                                  _t(B)[:, None], _t(C)[:, None])
    _close(ty[:, 0], y, SSD_TOL)
    _close(tst[:, 0], st, SSD_TOL)


def test_ssd_plain_broadcast_heads():
    """B and C shared by all heads (stride 0 over h, as ssd_scan passes
    them) equal the per-head contract with B and C repeated."""
    G, H, Q, P, N = 2, 3, 24, 8, 16
    x, cs, B, C = _ssd_inputs(G * H, Q, P, N, seed=1)
    Bg, Cg = _t(B[::H]), _t(C[::H])                        # (G, Q, N)
    rep = lambda a: np.repeat(a[::H], H, axis=0)           # noqa: E731
    y, st = ssd_intra_chunk(*map(jnp.asarray, (x, cs, rep(B), rep(C))),
                            interpret=True)
    ty, tst = ssd_ref.ssd_intra_chunk_ref(
        _t(x).view(G, H, Q, P), _t(cs).view(G, H, Q),
        Bg[:, None].expand(-1, H, -1, -1), Cg[:, None].expand(-1, H, -1, -1))
    _close(ty.reshape(G * H, Q, P), y, SSD_TOL)
    _close(tst.reshape(G * H, N, P), st, SSD_TOL)


def test_ssd_plain_masks_overflow_by_selection():
    """A steep cs makes exp(cs[t] - cs[s]) overflow above the diagonal; the
    mask selects instead of multiplying, so no inf · 0 = NaN reaches y."""
    G, Q, P, N = 1, 32, 4, 8
    x, _, B, C = _ssd_inputs(G, Q, P, N, seed=2)
    cs = -100.0 * np.arange(Q, dtype=np.float32)[None, :, None]
    y, st = ssd_ops.intra_chunk(_t(x)[:, None], _t(cs)[:, None, :, 0],
                                _t(B)[:, None], _t(C)[:, None])
    assert torch.isfinite(y).all() and torch.isfinite(st).all()
    jy, jst = ssd_intra_chunk(*map(jnp.asarray, (x, cs, B, C)),
                              interpret=True)
    _close(y[:, 0], jy, SSD_TOL)


# ------------------------------------------------------------- functions
def test_causal_conv_and_conv_step_match_jax():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 11, 6)).astype(np.float32)
    w = rng.normal(size=(4, 6)).astype(np.float32)
    b = rng.normal(size=(6,)).astype(np.float32)
    _close(tm.causal_conv(_t(x), _t(w), _t(b)),
           jm.causal_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)),
           1e-6)
    state = rng.normal(size=(2, 3, 6)).astype(np.float32)
    ts, ty = tm.conv_step(_t(state), _t(x[:, 0]), _t(w), _t(b))
    js, jy = jm.conv_step(*map(jnp.asarray, (state, x[:, 0], w, b)))
    _close(ts, js, 1e-6)
    _close(ty, jy, 1e-6)


@pytest.mark.parametrize("S", [10, 16, 37])
def test_ssd_scan_matches_jax(S):
    """S below, equal to and not a multiple of the chunk (16)."""
    rng = np.random.default_rng(S)
    Bb, H, P, N = 2, 3, 4, 8
    xh = rng.normal(size=(Bb, S, H, P)).astype(np.float32)
    dta = -np.log1p(np.exp(rng.normal(size=(Bb, S, H)))).astype(np.float32)
    Bm = rng.normal(size=(Bb, S, N)).astype(np.float32)
    Cm = rng.normal(size=(Bb, S, N)).astype(np.float32)
    y, h = tm.ssd_scan(_t(xh), _t(dta), _t(Bm), _t(Cm), chunk=16)
    jy, jh = jm.ssd_scan(*map(jnp.asarray, (xh, dta, Bm, Cm)), chunk=16)
    assert y.shape == (Bb, S, H, P) and h.shape == (Bb, H, P, N)
    _close(y, jy, SCAN_TOL)
    _close(h, jh, SCAN_TOL)


def test_mixer_state_and_step_match_jax(model):
    jcfg, tcfg, jp, tp = model
    ctx = single_device_ctx()
    jpl = jp["blocks"][0]["s0"]["mamba"]
    jlayer = jax.tree.map(lambda a: a[0], jpl)
    tlayer = tp["layers"][0]["mamba"]
    x = (np.random.default_rng(5).normal(size=(2, 45, tcfg.d_model)) *
         0.5).astype(np.float32)
    out, state = tm.mamba2_mixer(tcfg, tlayer, _t(x[:, :40]),
                                 return_state=True)
    jout, jstate = jm.mamba2_mixer(jcfg, jlayer, jnp.asarray(x[:, :40]), ctx,
                                   return_state=True)
    _close(out, jout, MIXER_TOL)
    for name in ("conv_x", "conv_B", "conv_C", "ssm"):
        _close(state[name], jstate[name], MIXER_TOL)
    for t in range(40, 45):
        out, state = tm.mamba2_step(tcfg, tlayer, _t(x[:, t]), state)
        jout, jstate = jm.mamba2_step(jcfg, jlayer, jnp.asarray(x[:, t]),
                                      jstate, ctx)
        _close(out, jout, MIXER_TOL)
    _close(state["ssm"], jstate["ssm"], MIXER_TOL)
    # the steps continue the full pass (tests/test_mamba.py)
    full = tm.mamba2_mixer(tcfg, tlayer, _t(x))
    _close(out, full[:, -1].numpy(), MIXER_TOL)


# --------------------------------------------------------- prefill/decode
def test_prefill_then_decode_equals_longer_prefill(model):
    """prefill(S) + one decode step of token S ≡ prefill(S + 1), with S
    crossing the smoke chunk (32); the per-slot state carries the
    prefill."""
    _, tcfg, _, tp = model
    S = 40
    toks = torch.tensor(np.random.default_rng(6).integers(
        0, tcfg.vocab, (2, S + 1)), dtype=torch.int32)
    want, _ = prefill(tcfg, tp, toks)
    _, state = prefill(tcfg, tp, toks[:, :S], page_size=8)
    cache = {"layers": state["layers"]}
    got, new = decode_step(tcfg, tp, cache, toks[:, S],
                           torch.full((2,), S, dtype=torch.int32),
                           torch.zeros((2, 8), dtype=torch.int32))
    _close(got, want.numpy(), ATOL)
    assert set(new["layers"][0]) == {"conv_x", "conv_B", "conv_C", "ssm"}


def test_cache_defs_hold_dense_state_and_no_pool(model):
    _, tcfg, _, _ = model
    defs = paged_cache_defs(tcfg, num_pages=9, page_size=8, max_slots=3,
                            max_len=64)
    H = tcfg.d_inner // tcfg.ssm.head_dim
    for layer in defs["layers"]:
        assert layer["ssm"].shape == (3, H, tcfg.ssm.head_dim,
                                      tcfg.ssm.d_state)
        assert layer["ssm"].dtype == torch.float32
        assert layer["conv_x"].shape == (3, tcfg.ssm.d_conv - 1,
                                         tcfg.d_inner)
        assert layer["conv_B"].dtype == tcfg.pdtype
    assert cache_kinds(tcfg) == ["dense"] * tcfg.n_layers


# ----------------------------------------------------------------- engine
LENS = [5, 5, 9, 17, 40, 70]          # 40 and 70 cross the smoke chunk
ENGINE_KW = dict(max_slots=2, max_len=96, page_size=8, decode_quantum=3)


def test_engine_greedy_streams_match_jax(model, monkeypatch):
    jcfg, tcfg, jp, tp = model
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, tcfg.vocab, n).tolist() for n in LENS]
    jeng = jmake_engine(jcfg, single_device_ctx(), paged=True, **ENGINE_KW)
    jreqs = [JRequest(rid=i, prompt=p, max_new=6)
             for i, p in enumerate(prompts)]
    jeng.run(jreqs)
    assert jeng.pad_safe is False
    groups = []
    orig = teng.prefill
    monkeypatch.setattr(teng, "prefill", lambda cfg, params, toks, **kw:
                        groups.append(tuple(toks.shape)) or
                        orig(cfg, params, toks, **kw))
    eng = teng.Engine(tcfg, tp, device="cpu", **ENGINE_KW)
    assert eng.pad_safe is False
    reqs = [teng.Request(rid=i, prompt=p, max_new=6)
            for i, p in enumerate(prompts)]
    eng.run(reqs)
    assert all(r.done and len(r.out) == 6 for r in reqs)
    # exact-length groups, power-of-2 batches: no row carries pad tokens
    assert all(S in LENS and P & (P - 1) == 0 for P, S in groups)
    eng.alloc.check()
    assert len(eng.alloc.free) == eng.alloc.usable_pages
    assert [r.out for r in reqs] == [r.out for r in jreqs], \
        [(a.out, b.out) for a, b in zip(jreqs, reqs)]


def test_engine_admit_writes_only_the_admitted_slots(model):
    """The dense-state admit writes the group's rows into their slots and
    leaves every other slot as it was."""
    _, tcfg, _, tp = model
    eng = teng.Engine(tcfg, tp, device="cpu", **ENGINE_KW)
    before = tree_map(lambda t: t.clone(), eng.cache)
    eng.submit(teng.Request(rid=0, prompt=list(range(1, 12)), max_new=4))
    eng._admit_pending(eng.free_slots())
    slot = next(i for i, r in enumerate(eng.slot_req) if r is not None)
    _, state = prefill(tcfg, tp, torch.arange(1, 12,
                                              dtype=torch.int32)[None])
    for layer, old, new in zip(eng.cache["layers"], before["layers"],
                               state["layers"]):
        for name, t in layer.items():
            _close(t[slot], new[name][0].numpy(), 1e-6)
            other = [i for i in range(eng.max_slots) if i != slot]
            assert torch.equal(t[other], old[name][other])


# --------------------------------------------------------------- refusals
def test_check_supported_refuses_mamba1_hybrids_and_ffn_blocks():
    """Serving and training take Mamba-1, hybrids and Mamba blocks with an
    FFN (jamba: ``tests/test_torch_jamba.py``), and now also a hybrid's
    attention layers without an FFN and post-norm Mamba blocks, Mamba-1 and
    Mamba-2, with and without an FFN (held against JAX in
    ``tests/test_torch_variants.py``): the engine builds each. An SSM
    version other than 1 and 2 is refused, by serving and training alike."""
    t = tconfigs.smoke_config(tconfigs.get_config(ARCH))
    ttr.check_supported(t)
    ttr.check_trainable(t)
    hybrid = dataclasses.replace(t, ssm=dataclasses.replace(t.ssm,
                                                            attn_period=2),
                                 family="hybrid")
    cases = (dict(ssm=dataclasses.replace(t.ssm, version=1)),
             dict(ssm=hybrid.ssm, family="hybrid", d_ff=128),
             dict(d_ff=128), dict(ssm=hybrid.ssm, family="hybrid"),
             dict(use_post_norm=True),
             dict(use_post_norm=True, d_ff=128,
                  ssm=dataclasses.replace(t.ssm, version=1)))
    for ok in cases:
        cfg = dataclasses.replace(t, **ok)
        ttr.check_supported(cfg)
        teng.Engine(cfg, init_params(cfg, device="cpu"), device="cpu")
        ttr.check_trainable(cfg)
    bad = dataclasses.replace(t, ssm=dataclasses.replace(t.ssm, version=3))
    for check in (ttr.check_supported, ttr.check_trainable):
        with pytest.raises(NotImplementedError, match="SSM version 3"):
            check(bad)
    with pytest.raises(NotImplementedError, match="SSM version 3"):
        teng.Engine(bad, None, device="cpu")
