"""The port's front-end decoder (internvl2-26b) against the JAX package on
the CPU, at smoke size (2 layers, 4 heads over 2, 8 front-end positions of
width 32): the parameter tree and count, ``embed`` and ``lm_hidden`` with
``frontend_embed``, ``prefill`` with it (exact-length and bucketed with
``prompt_len``; prompts shorter than the front end refused), greedy
``prefill(frontend_embed)`` + ``decode_step`` streams, the engine's text
streams (paged and dense) against the JAX fast engine, and the serving
launcher on the arch. Parameters come from the JAX initializer, inputs
from numpy seeds. Tolerances: f32 1e-4, bf16 3e-2 of the largest value."""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import all_configs, smoke_config
from repro.models import layers as jl
from repro.models import transformer as jtr
from repro.models.model import model_defs
from repro.serve import decode as jdec
from repro.serve import prefill as jpre
from repro.serve.engine import Request as JRequest
from repro.serve.engine import make_engine as jmake_engine
from repro.sharding import params as prm
from repro_torch import configs as tconfigs
from repro_torch.models import layers as tl
from repro_torch.models import transformer as ttr
from repro_torch.params import n_params, param_specs, params_from_numpy
from repro_torch.serve import decode as tdec
from repro_torch.serve import engine as teng
from repro_torch.serve import prefill as tpre

ARCH = "internvl2-26b"
ATOL = 1e-4
BF16_REL = 3e-2
LENS = [4, 5, 9, 17, 18, 23, 63]   # tests/test_serve.py engine workload
ROOT = Path(__file__).resolve().parents[1]


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


def _inputs(cfg, B, S, seed):
    """Seeded tokens (B, S) and patch embeddings (B, F, frontend_dim) × 0.1
    (``synth_batch``'s scale)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    fe = (rng.normal(size=(B, cfg.frontend_tokens, cfg.frontend_dim)) * 0.1
          ).astype(np.float32)
    return toks, fe


# ------------------------------------------------------ config and params
def test_config_and_param_count_match_jax():
    """The config equals JAX's; the parameter count equals
    ``n_params(model_defs(cfg))`` at full width (19.9 B) and smoke size;
    ``embed.frontend_proj`` is (frontend_dim, d_model)."""
    for smoke in (False, True):
        j, t = all_configs()[ARCH], tconfigs.get_config(ARCH)
        if smoke:
            j, t = smoke_config(j), tconfigs.smoke_config(t)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert [dataclasses.asdict(b) for b in ttr.block_cfgs(t)] == \
            [dataclasses.asdict(jtr.block_cfg_for_layer(j, i))
             for i in range(j.n_layers)]
        assert n_params(t) == prm.n_params(model_defs(j))
        assert param_specs(t)["embed"]["frontend_proj"].shape == \
            (t.frontend_dim, t.d_model)
    assert 19.8e9 < n_params(tconfigs.get_config(ARCH)) < 20.0e9


# ---------------------------------------------------------- model modules
def test_embed_with_frontend_matches_jax(ctx, model):
    """The projected patch embeddings replace the first F positions."""
    jcfg, tcfg, jp, tp = model
    toks, fe = _inputs(tcfg, 2, 20, seed=0)
    got = tl.embed(tcfg, tp["embed"], torch.from_numpy(toks),
                   torch.from_numpy(fe))
    want = jl.embed(jcfg, jp["embed"], jnp.asarray(toks), ctx,
                    jnp.asarray(fe))
    assert got.dtype == tcfg.pdtype
    _close(got, want, jcfg.param_dtype)
    plain = tl.embed(tcfg, tp["embed"], torch.from_numpy(toks))
    F = tcfg.frontend_tokens
    assert torch.equal(got[:, F:], plain[:, F:])
    assert not torch.equal(got[:, :F], plain[:, :F])


def test_lm_hidden_with_frontend_matches_jax(ctx, model):
    jcfg, tcfg, jp, tp = model
    toks, fe = _inputs(tcfg, 2, 24, seed=1)
    got, _ = ttr.lm_hidden(tcfg, tp, torch.from_numpy(toks),
                           torch.from_numpy(fe))
    want, _ = jtr.lm_hidden(jcfg, jp, jnp.asarray(toks), ctx,
                            jnp.asarray(fe))
    _close(got, want, jcfg.param_dtype)


# --------------------------------------------------------------- prefill
@pytest.mark.parametrize("bucketed", [False, True],
                         ids=["exact", "prompt_len"])
def test_prefill_with_frontend_matches_jax(ctx, model, bucketed):
    """Logits and (f32) every layer's cache rows, exact-length and bucketed
    (rows right-padded to 32 with their own ``prompt_len``, paged rows of
    page 8)."""
    jcfg, tcfg, jp, tp = model
    toks, fe = _inputs(tcfg, 2, 32, seed=2)
    kw, jkw = {}, {}
    if bucketed:
        lens = np.array([11, 32], np.int32)
        toks[0, 11:] = 0
        kw = dict(prompt_len=torch.from_numpy(lens), page_size=8)
        jkw = dict(prompt_len=jnp.asarray(lens), page_size=8)
    logits, cache = tpre.prefill(tcfg, tp, torch.from_numpy(toks),
                                 frontend_embed=torch.from_numpy(fe), **kw)
    jlogits, jcache = jpre.prefill(jcfg, jp, jnp.asarray(toks), ctx,
                                   frontend_embed=jnp.asarray(fe), **jkw)
    _close(logits, jlogits, jcfg.param_dtype)
    if jcfg.param_dtype != "float32":
        return
    for i, layer in enumerate(cache["layers"]):
        for name in ("k", "v"):
            _close(layer[name], jcache["blocks"][0]["s0"][name][i],
                   "float32")


def test_prefill_refuses_prompts_shorter_than_the_frontend(ctx):
    """Fewer tokens than front-end positions: a TypeError in both packages
    (JAX's shapes do not broadcast); a ``prompt_len`` below them: a
    ValueError in the port (JAX computes it)."""
    jcfg, tcfg = _cfgs("float32")
    jp = prm.materialize(model_defs(jcfg), jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    toks, fe = _inputs(tcfg, 2, 5, seed=3)
    with pytest.raises(TypeError):
        jpre.prefill(jcfg, jp, jnp.asarray(toks), ctx,
                     frontend_embed=jnp.asarray(fe))
    with pytest.raises(TypeError):
        tpre.prefill(tcfg, tp, torch.from_numpy(toks),
                     frontend_embed=torch.from_numpy(fe))
    toks, fe = _inputs(tcfg, 2, 16, seed=3)
    with pytest.raises(ValueError):
        tpre.prefill(tcfg, tp, torch.from_numpy(toks),
                     prompt_len=torch.tensor([4, 16]),
                     frontend_embed=torch.from_numpy(fe))


def test_prefill_step_fn_takes_the_frontend(model):
    jcfg, tcfg, jp, tp = model
    toks, fe = _inputs(tcfg, 2, 12, seed=4)
    toks, fe = torch.from_numpy(toks), torch.from_numpy(fe)
    got, _ = tpre.prefill_step_fn(tcfg)(tp, toks, fe)
    want, _ = tpre.prefill(tcfg, tp, toks, frontend_embed=fe)
    assert torch.equal(got, want)


# ------------------------------------------------ image requests (greedy)
def test_image_greedy_streams_match_jax(ctx):
    """``prefill(frontend_embed)`` of two image prompts (8 patch positions
    and text) into dense rows, then 12 greedy ``decode_step``s: the same
    tokens as JAX's prefill and jitted decode step (f32)."""
    jcfg, tcfg = _cfgs("float32")
    jp = prm.materialize(model_defs(jcfg), jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    toks, fe = _inputs(tcfg, 2, 19, seed=5)
    max_len = 40
    logits, cache = tpre.prefill(tcfg, tp, torch.from_numpy(toks),
                                 max_len=max_len,
                                 frontend_embed=torch.from_numpy(fe))
    jlogits, jcache = jpre.prefill(jcfg, jp, jnp.asarray(toks), ctx,
                                   frontend_embed=jnp.asarray(fe),
                                   max_len=max_len)
    jstep = jax.jit(lambda p, c, t, q: jdec.decode_step(jcfg, p, c, t, q,
                                                        ctx))
    tok, jtok = logits.argmax(-1), jnp.argmax(jlogits, -1).astype(jnp.int32)
    got, want = [tok.tolist()], [np.asarray(jtok).tolist()]
    for t in range(19, 31):
        logits, cache = tdec.decode_step(tcfg, tp, cache, tok,
                                         torch.full((2,), t))
        jlogits, jcache = jstep(jp, jcache, jtok,
                                jnp.full((2,), t, jnp.int32))
        tok = logits.argmax(-1)
        jtok = jnp.argmax(jlogits, -1).astype(jnp.int32)
        got.append(tok.tolist())
        want.append(np.asarray(jtok).tolist())
    assert got == want


# ----------------------------------------------------- engine (text only)
@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
def test_engine_text_streams_match_jax(ctx, paged):
    """internvl2 served as text by the engine, paged and dense: greedy
    streams identical to the JAX fast engine's (f32), the pool whole."""
    jcfg, tcfg = _cfgs("float32")
    jp = prm.materialize(model_defs(jcfg), jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, tcfg.vocab, n).tolist() for n in LENS]
    kw = dict(max_slots=3, max_len=64, page_size=8, decode_quantum=4)
    jeng = jmake_engine(jcfg, ctx, paged=paged, **kw)
    jreqs = [JRequest(rid=i, prompt=p, max_new=6)
             for i, p in enumerate(prompts)]
    jeng.run(jreqs)
    eng = teng.Engine(tcfg, tp, device="cpu", paged=paged, **kw)
    reqs = [teng.Request(rid=i, prompt=p, max_new=6)
            for i, p in enumerate(prompts)]
    eng.run(reqs)
    assert all(r.done for r in reqs)
    assert [len(r.out) for r in reqs] == [6, 6, 6, 6, 6, 6, 2]  # 63 of 64
    if paged:
        eng.alloc.check()
        assert len(eng.alloc.free) == eng.alloc.usable_pages
    assert [r.out for r in reqs] == [r.out for r in jreqs]


def test_serve_launcher_takes_the_arch():
    """``python -m repro_torch.launch.serve --arch internvl2-26b`` serves
    the smoke config (here on the CPU) and exits 0."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", ARCH,
         "--requests", "4", "--max-new", "4", "--device", "cpu"],
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.startswith("served 4 requests"), out.stdout


def test_every_registered_config_loads_and_serves():
    """The port registers the JAX package's configs, each with JAX's
    parameter count at full width; at smoke size each serves: decoders
    (internvl2 as text) through the engine, the encoder-decoder through
    ``prefill_step_fn``/``serve_step_fn``."""
    from repro_torch.params import init_params
    assert sorted(tconfigs.all_configs()) == sorted(all_configs())
    for name, cfg in tconfigs.all_configs().items():
        assert n_params(cfg) == prm.n_params(model_defs(all_configs()[name]))
        cfg = tconfigs.smoke_config(cfg)
        params = init_params(cfg, seed=0, device="cpu")
        if cfg.enc_dec:
            frames = torch.randn((1, 16, cfg.d_model),
                                 generator=torch.Generator().manual_seed(0))
            _, cache = tpre.prefill_step_fn(cfg)(params, frames)
            step = tdec.serve_step_fn(cfg)
            for t in range(2):
                logits, cache = step(params, cache, torch.tensor([1]),
                                     torch.tensor([t]))
            assert logits.shape == (1, cfg.vocab)
            assert bool(torch.isfinite(logits).all()), name
            continue
        eng = teng.Engine(cfg, params, device="cpu", max_slots=2, max_len=32,
                          page_size=8, decode_quantum=2)
        req = teng.Request(rid=0, prompt=[1, 2, 3, 4, 5], max_new=2)
        eng.run([req])
        assert req.done and len(req.out) == 2, name
