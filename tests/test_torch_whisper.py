"""The port's encoder-decoder (whisper-large-v3) against the JAX package on
the CPU, at smoke size (2 + 2 layers, d 64, 4 heads of 16,
``max_decoder_len`` 16): the parameter tree and count, ``sinusoids``,
``encode``, ``decode_hidden``, ``whisper_prefill`` (encoder states and
every layer's cross K/V), ``whisper_decode_step`` (logits and self rows,
also past ``max_decoder_len``), a greedy stream of 20 steps, and the
dispatch of ``prefill_step_fn``/``serve_step_fn``. Parameters come from
the JAX initializer, inputs from numpy seeds. Tolerances: f32 1e-4, bf16
3e-2 of the largest value (``tests/test_serve.py``)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import all_configs, smoke_config
from repro.models import whisper as jwh
from repro.models.model import model_defs
from repro.serve import decode as jdec
from repro.serve import prefill as jpre
from repro.serve.engine import Engine as JEngine
from repro.sharding import params as prm
from repro_torch import configs as tconfigs
from repro_torch.models import whisper as twh
from repro_torch.models.transformer import check_supported
from repro_torch.params import init_params, n_params, params_from_numpy
from repro_torch.serve import decode as tdec
from repro_torch.serve import prefill as tpre
from repro_torch.serve.engine import Engine
from repro_torch.serve.kv_cache import encdec_cache_defs

ARCH = "whisper-large-v3"
ATOL = 1e-4
BF16_REL = 3e-2
B, SE = 2, 32                 # batch and encoder frames of the smoke runs


def _cfgs(dtype):
    j = dataclasses.replace(smoke_config(all_configs()[ARCH]),
                            param_dtype=dtype)
    t = dataclasses.replace(tconfigs.smoke_config(tconfigs.get_config(ARCH)),
                            param_dtype=dtype)
    return j, t


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def model(request):
    jcfg, tcfg = _cfgs(request.param)
    jp = prm.materialize(model_defs(jcfg), jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    return jcfg, tcfg, jp, tp


def _frames(seed=1, n=SE):
    return (np.random.default_rng(seed).normal(size=(B, n, 64)) * 0.1
            ).astype(np.float32)


def _close(got, want, dtype):
    got = np.asarray(got.float() if torch.is_tensor(got) else got,
                     np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=ATOL, atol=ATOL)
    else:
        rel = np.abs(got - want).max() / np.abs(want).max()
        assert rel < BF16_REL, rel


def _jax_cache(tcache, jcfg):
    """The port's per-layer cache as JAX's stacked ``dec_blocks``."""
    return {"dec_blocks": {n: jnp.asarray(np.stack(
        [c[n].float().numpy() for c in tcache["dec_layers"]])).astype(
        jcfg.pdtype) for n in ("k", "v", "xk", "xv")}}


# ------------------------------------------------------ config and params
def test_config_and_param_count_match_jax():
    """The config equals JAX's field by field; the parameter count equals
    ``n_params(model_defs(cfg))`` at full width (1.54 B) and smoke size;
    the tree carried from ``materialize`` has the specs' shapes and dtypes
    (``params_from_numpy`` checks), and ``init_params`` makes it."""
    for smoke in (False, True):
        j, t = all_configs()[ARCH], tconfigs.get_config(ARCH)
        if smoke:
            j, t = smoke_config(j), tconfigs.smoke_config(t)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert n_params(t) == prm.n_params(model_defs(j))
    assert 1.5e9 < n_params(tconfigs.get_config(ARCH)) < 1.6e9
    _, tcfg = _cfgs("float32")
    tp = init_params(tcfg, seed=0, device="cpu")
    assert len(tp["enc_layers"]) == 2 and len(tp["dec_layers"]) == 2
    assert set(tp["dec_layers"][0]) == {"norm1", "self_attn", "norm_x",
                                       "cross", "norm2", "mlp"}
    assert tp["unembed"] == {} and "frontend_proj" not in tp["embed"]
    assert float(tp["dec_pos"].std()) < 0.015      # scale 0.01


@pytest.mark.parametrize("length,channels", [(32, 64), (1500, 1280)])
def test_sinusoids_match_jax(length, channels):
    """f32 sinusoids against JAX's. The argument t·s reaches ~length, and
    the two frameworks' exp may round s one ulp apart, so beside 1e-4 the
    bound allows one ulp of the largest argument (1.2e-4 at 1500 frames;
    4e-6 at 32)."""
    got = twh.sinusoids(length, channels)
    want = np.asarray(jwh.sinusoids(length, channels))
    assert got.dtype == torch.float32
    tol = ATOL + float(np.spacing(np.float32(length)))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)


# ---------------------------------------------------------- model modules
def test_encode_matches_jax(ctx, model):
    """The encoder: frames cast to the parameter dtype before the
    sinusoids are added, non-causal self attention, RMSNorm."""
    jcfg, tcfg, jp, tp = model
    fr = _frames()
    got = twh.encode(tcfg, tp, torch.from_numpy(fr))
    want = jwh.encode(jcfg, jp, jnp.asarray(fr), ctx)
    assert got.dtype == tcfg.pdtype
    _close(got, want, jcfg.param_dtype)


def test_decode_hidden_matches_jax(ctx, model):
    jcfg, tcfg, jp, tp = model
    fr = _frames()
    toks = np.random.default_rng(2).integers(0, tcfg.vocab, (B, 7))
    enc = twh.encode(tcfg, tp, torch.from_numpy(fr))
    jenc = jwh.encode(jcfg, jp, jnp.asarray(fr), ctx)
    got = twh.decode_hidden(tcfg, tp, torch.from_numpy(toks), enc)
    want = jwh.decode_hidden(jcfg, jp, jnp.asarray(toks, jnp.int32), jenc,
                             ctx)
    _close(got, want, jcfg.param_dtype)


# -------------------------------------------------------- prefill / decode
def test_whisper_prefill_matches_jax(ctx, model):
    """``enc_out`` and every layer's ``xk``/``xv``; the self rows zero, of
    ``max_decoder_len``; the cache laid out as ``encdec_cache_defs``."""
    jcfg, tcfg, jp, tp = model
    fr = _frames()
    enc, cache = tpre.whisper_prefill(tcfg, tp, torch.from_numpy(fr))
    jenc, jcache = jpre.whisper_prefill(jcfg, jp, jnp.asarray(fr), ctx)
    _close(enc, jenc, jcfg.param_dtype)
    defs = encdec_cache_defs(tcfg, B, SE)
    assert len(cache["dec_layers"]) == tcfg.n_layers
    for i, c in enumerate(cache["dec_layers"]):
        assert {n: (tuple(t.shape), t.dtype) for n, t in c.items()} == \
            {n: (s.shape, s.dtype) for n, s in defs["dec_layers"][i].items()}
        assert not c["k"].any() and not c["v"].any()
        for n in ("xk", "xv"):
            _close(c[n], np.asarray(jcache["dec_blocks"][n][i], np.float32),
                   jcfg.param_dtype)


def _step_both(ctx, jcfg, tcfg, jp, tp, positions, seed):
    """From one prefill, the port's and JAX's ``whisper_decode_step`` over
    ``positions`` (steps × B) with seeded tokens → per step (logits, self
    rows) of each."""
    fr = _frames()
    _, tcache = tpre.whisper_prefill(tcfg, tp, torch.from_numpy(fr))
    jcache = _jax_cache(tcache, jcfg)
    jstep = jax.jit(lambda p, c, t, q: jdec.whisper_decode_step(
        jcfg, p, c, t, q, ctx))
    rng = np.random.default_rng(seed)
    out = []
    for pos in positions:
        toks = rng.integers(0, tcfg.vocab, B).astype(np.int32)
        pos = np.asarray(pos, np.int32)
        lg, tcache = tdec.whisper_decode_step(tcfg, tp, tcache,
                                              torch.from_numpy(toks),
                                              torch.from_numpy(pos))
        jlg, jcache = jstep(jp, jcache, jnp.asarray(toks), jnp.asarray(pos))
        out.append((lg, jlg, [(c["k"].clone(), c["v"].clone())
                              for c in tcache["dec_layers"]], jcache))
    return out


def test_decode_step_matches_jax(ctx, model):
    """Six steps from position 0: logits within tolerance, and (f32) every
    layer's self rows equal to JAX's."""
    jcfg, tcfg, jp, tp = model
    steps = _step_both(ctx, jcfg, tcfg, jp, tp,
                       [[t, t] for t in range(6)], seed=3)
    for lg, jlg, rows, jcache in steps:
        assert lg.dtype == torch.float32 and lg.shape == (B, tcfg.vocab)
        _close(lg, jlg, jcfg.param_dtype)
    if jcfg.param_dtype == "float32":
        for i, (k, v) in enumerate(rows):
            _close(k, jcache["dec_blocks"]["k"][i], "float32")
            _close(v, jcache["dec_blocks"]["v"][i], "float32")


def test_decode_step_past_max_decoder_len_matches_jax(ctx, model):
    """Positions running past ``max_decoder_len`` (16): the writes are
    dropped (the rows keep what the earlier steps wrote), every row is
    live, ``dec_pos`` is read at its last row; logits and rows as JAX's."""
    jcfg, tcfg, jp, tp = model
    L = tcfg.max_decoder_len
    positions = [[t, L - 3 + t] for t in range(6)]       # row 1: 13 .. 18
    steps = _step_both(ctx, jcfg, tcfg, jp, tp, positions, seed=4)
    for lg, jlg, _, _ in steps:
        _close(lg, jlg, jcfg.param_dtype)
    rows = steps[-1][2]
    before = steps[2][2]                  # row 1 wrote 13, 14, 15, then no more
    for (k, _), (k0, _) in zip(rows, before):
        assert torch.equal(k[1], k0[1])
    if jcfg.param_dtype == "float32":
        for i, (k, v) in enumerate(rows):
            _close(k, steps[-1][3]["dec_blocks"]["k"][i], "float32")
            _close(v, steps[-1][3]["dec_blocks"]["v"][i], "float32")


def test_decode_steps_match_decode_hidden(model):
    """Five steps of ``whisper_decode_step`` against ``decode_hidden`` over
    the same tokens (the JAX test's check, here within the port)."""
    jcfg, tcfg, jp, tp = model
    fr = torch.from_numpy(_frames())
    enc, cache = tpre.whisper_prefill(tcfg, tp, fr)
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, tcfg.vocab, (B, 5)))
    h = twh.decode_hidden(tcfg, tp, toks, enc)
    ref = h[:, -1].float() @ tp["embed"]["table"].T.float()
    for t in range(5):
        lg, cache = tdec.whisper_decode_step(tcfg, tp, cache, toks[:, t],
                                             torch.full((B,), t))
    _close(lg, ref.numpy(), jcfg.param_dtype)


def test_greedy_stream_matches_jax(ctx):
    """A greedy stream of 20 steps (past ``max_decoder_len`` = 16) through
    ``prefill_step_fn``/``serve_step_fn``: identical to JAX's loop of
    ``whisper_decode_step`` (f32)."""
    jcfg, tcfg = _cfgs("float32")
    jp = prm.materialize(model_defs(jcfg), jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    fr = _frames(seed=5)
    _, cache = tpre.prefill_step_fn(tcfg)(tp, torch.from_numpy(fr))
    _, jcache = jpre.prefill_step_fn(jcfg, ctx)(jp, jnp.asarray(fr))
    step = tdec.serve_step_fn(tcfg)
    jstep = jax.jit(jdec.serve_step_fn(jcfg, ctx))
    tok = torch.tensor([1, 7])
    jtok = jnp.asarray([1, 7], jnp.int32)
    got, want = [], []
    for t in range(20):
        lg, cache = step(tp, cache, tok, torch.full((B,), t))
        jlg, jcache = jstep(jp, jcache, jtok, jnp.full((B,), t, jnp.int32))
        tok, jtok = lg.argmax(-1), jnp.argmax(jlg, -1).astype(jnp.int32)
        got.append(tok.tolist())
        want.append(np.asarray(jtok).tolist())
    assert got == want


def test_engine_refuses_enc_dec_as_jax(ctx):
    """Neither engine takes an encoder-decoder; both name
    ``whisper_decode_step`` (JAX by an assert, the port by a typed
    error)."""
    jcfg, tcfg = _cfgs("float32")
    tp = init_params(tcfg, seed=0, device="cpu")
    jp = prm.materialize(model_defs(jcfg), jax.random.PRNGKey(0))
    with pytest.raises(AssertionError, match="whisper_decode_step"):
        JEngine(jcfg, jp, ctx)
    with pytest.raises(NotImplementedError, match="whisper_decode_step"):
        Engine(tcfg, tp, device="cpu")
    with pytest.raises(NotImplementedError, match="whisper_decode_step"):
        check_supported(tcfg)
