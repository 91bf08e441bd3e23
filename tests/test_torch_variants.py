"""Block combinations that the JAX model code builds and no registered
config uses, held against the JAX package on the CPU in f32: an MoE FFN
without a gate (phi3.5-moe smoke with ``act="relu2"``: two grouped GEMMs
around the activation), post-norm Mamba-1 blocks with an FFN
(mamba2-130m smoke with ``version`` 1 and ``d_ff`` 128), post-norm Mamba-2
blocks and attention layers, neither with an FFN (mamba2-130m smoke as a
post-norm hybrid with ``attn_period`` 2: ``post1`` after every mixer,
``post2`` only after an FFN). The MoE block alone and windowed MLA, which
the port trains and does not serve, are held in
``tests/test_torch_variants_parts.py``, whose oracles share this file's
helpers.

For each variant: the parameter tree, the forward, prefill logits
and cache, decode steps, the paged engine's greedy streams against the JAX
fast engine, and the loss with every gradient leaf at
``tests/test_torch_train.py``'s f32 tolerances. The JAX side runs on a 1×1
mesh with Auto axes: on the default Explicit-axis mesh the gradients of the
MoE variant and of windowed MLA raise a ``ShardingTypeError``
(``repro/models/attention.py``'s ``_attend_bwd``); the other oracles are
green on both meshes. Prompts stay shorter than the smoke chunk (32), where
JAX's Mamba-1 conv state is right."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import all_configs, smoke_config
from repro.models.model import loss_fn as jloss_fn
from repro.models.model import model_defs
from repro.models.transformer import lm_hidden as jlm_hidden
from repro.serve import decode as jdec
from repro.serve import prefill as jpre
from repro.serve.engine import Request as JRequest
from repro.serve.engine import Engine as JEngine
from repro.sharding import params as prm
from repro_torch import configs as tconfigs
from repro_torch.models import transformer as ttr
from repro_torch.models.model import loss_fn
from repro_torch.models.transformer import lm_hidden
from repro_torch.params import (init_params, n_params, params_from_numpy,
                                tree_leaves, tree_map)
from repro_torch.serve import engine as teng
from repro_torch.serve.decode import decode_step
from repro_torch.serve.prefill import prefill
from repro_torch.train.step import make_state
from test_torch_jamba import _unstack, auto_ctx, jax_params  # noqa: F401

ATOL = 1e-4              # f32 logits and states, as tests/test_torch_serve.py
GRAD_TOL, LOSS_TOL = 1e-4, 1e-5    # tests/test_torch_train.py, f32
PINNED_F = 0.01
LENS = [5, 13]           # one bucket (16), each shorter than the smoke chunk (32)
ENGINE_KW = dict(max_slots=3, max_len=48, page_size=8, decode_quantum=4)
# the oracles' own jits compile at XLA's lowest optimization level: a third
# of the file's time goes to compiling them, and f32 results agree to
# rounding
_jit = functools.partial(jax.jit, compiler_options={
    "xla_backend_optimization_level": 0,
    "xla_llvm_disable_expensive_passes": True})
PHI, MAMBA2, DEEPSEEK = ("phi3.5-moe-42b-a6.6b", "mamba2-130m",
                         "deepseek-v2-236b")


def _vary(cfg, name):
    """The variant ``name`` of a smoke config (either package's)."""
    s = cfg.ssm
    return {"moe-relu2": lambda: dataclasses.replace(cfg, act="relu2"),
            "mamba1-postnorm": lambda: dataclasses.replace(
                cfg, ssm=dataclasses.replace(s, version=1),
                use_post_norm=True, d_ff=128),
            "hybrid-postnorm-noffn": lambda: dataclasses.replace(
                cfg, family="hybrid", use_post_norm=True,
                ssm=dataclasses.replace(s, attn_period=2)),
            "mla-window": lambda: dataclasses.replace(
                cfg, sliding_window=16, local_global_period=2)}[name]()


VARIANTS = {"moe-relu2": PHI, "mamba1-postnorm": MAMBA2,
            "hybrid-postnorm-noffn": MAMBA2}


def _cfgs(name, arch=None):
    arch = arch or VARIANTS[name]
    j = smoke_config(all_configs()[arch])
    t = tconfigs.smoke_config(tconfigs.get_config(arch))
    return (_vary(dataclasses.replace(j, param_dtype="float32"), name),
            _vary(dataclasses.replace(t, param_dtype="float32"), name))


_MODELS = {}


def _model(name, arch=None):
    """(jcfg, tcfg, JAX params, the same numbers on the port): the port's
    seeded initializer, carried to JAX's tree, cached."""
    key = (name, arch)
    if key not in _MODELS:
        jcfg, tcfg = _cfgs(name, arch)
        tp = init_params(tcfg, 0, device="cpu")
        _MODELS[key] = jcfg, tcfg, jax_params(tcfg, tp), tp
    return _MODELS[key]


def _close(got, want, tol=ATOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def _tokens(vocab, shape, seed):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def _rel(a, b) -> float:
    a, b = a.detach().float(), b.detach().float()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


# ---------------------------------------------------------- the variants
@pytest.mark.parametrize("name", list(VARIANTS))
def test_forward_prefill_decode_match_jax(name, auto_ctx):
    """The parameter tree (leaf names and counts: no ``w_gate``/``ws_gate``
    without a gate, ``post2`` only after an FFN), ``lm_hidden`` (and the
    router stats), prefill logits and every layer's cache, and three decode
    steps against JAX's."""
    jcfg, tcfg, jp, tp = _model(name)
    ttr.check_supported(tcfg)
    ttr.check_trainable(tcfg)
    assert n_params(tcfg) == prm.n_params(model_defs(jcfg))
    for bc, layer in zip(ttr.block_cfgs(tcfg), tp["layers"]):
        assert ("post1" in layer) == tcfg.use_post_norm
        assert ("post2" in layer) == (tcfg.use_post_norm and bc.ffn != "none")
        assert ("norm2" in layer) == (bc.ffn != "none")
        if bc.ffn == "moe":
            assert "w_gate" not in layer["moe"]
    kinds = {(bc.mixer, bc.ffn) for bc in ttr.block_cfgs(tcfg)}
    assert kinds == {"moe-relu2": {("attn", "moe")},
                     "mamba1-postnorm": {("mamba", "dense")},
                     "hybrid-postnorm-noffn": {("attn", "none"),
                                               ("mamba", "none")}}[name]
    toks = _tokens(tcfg.vocab, (2, 24), 1)
    with torch.no_grad():
        h, stats = lm_hidden(tcfg, tp, torch.from_numpy(toks))
    jh, jstats = _jit(lambda p, t: jlm_hidden(jcfg, p, t, auto_ctx))(
        jp, jnp.asarray(toks))
    _close(h, jh)
    if tcfg.moe is not None:
        _close(stats, jstats, 1e-6)
    S, max_len = 19, 32
    logits, cache = prefill(tcfg, tp, torch.from_numpy(toks[:, :S]),
                            max_len=max_len)
    jlogits, jcache = _jit(lambda p, t: jpre.prefill(
        jcfg, p, t, auto_ctx, max_len=max_len))(jp, jnp.asarray(toks[:, :S]))
    _close(logits, jlogits)
    for i, (layer, jlayer) in enumerate(zip(
            cache["layers"], _unstack(tcfg, jcache["blocks"]))):
        assert set(layer) == set(jlayer), i
        for n, t in layer.items():
            _close(t, jlayer[n])
    jstep = _jit(lambda p, c, t, pos: jdec.decode_step(jcfg, p, c, t, pos,
                                                          auto_ctx))
    for k in range(3):
        pos = np.full(2, S + k, np.int32)
        got, cache = decode_step(tcfg, tp, cache,
                                 torch.from_numpy(toks[:, S + k]),
                                 torch.from_numpy(pos))
        want, jcache = jstep(jp, jcache, jnp.asarray(toks[:, S + k]),
                             jnp.asarray(pos))
        _close(got, want)


@pytest.mark.parametrize("name", list(VARIANTS))
def test_engine_greedy_streams_match_jax(name, auto_ctx, monkeypatch):
    """Prompts of 5 and 19 tokens, 6 new each, through the JAX fast
    engine and the port's paged engine, both admitting at ``PINNED_F`` (MoE
    capacity couples a prefill group's rows): token-identical streams, the
    pool whole after the run."""
    jcfg, tcfg, jp, tp = _model(name)
    prompts = [_tokens(tcfg.vocab, n, 10 + n).tolist() for n in LENS]
    jeng = JEngine(jcfg, jp, auto_ctx, fast=True, paged=True, **ENGINE_KW)
    monkeypatch.setattr(jeng.tracker, "f", lambda: PINNED_F)
    jreqs = [JRequest(rid=i, prompt=p, max_new=6)
             for i, p in enumerate(prompts)]
    jeng.run(jreqs)
    eng = teng.Engine(tcfg, tp, device="cpu", paged=True, **ENGINE_KW)
    monkeypatch.setattr(eng.tracker, "f", lambda: PINNED_F)
    reqs = [teng.Request(rid=i, prompt=p, max_new=6)
            for i, p in enumerate(prompts)]
    eng.run(reqs)
    assert all(r.done and len(r.out) == 6 for r in reqs)
    assert eng.pad_safe == jeng.pad_safe
    eng.alloc.check()
    assert len(eng.alloc.free) == eng.alloc.usable_pages
    assert [r.out for r in reqs] == [r.out for r in jreqs]


def _batch(vocab, B=2, S=32, seed=1):
    toks = _tokens(vocab, (B, S + 1), seed)
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:],
            "mask": np.ones((B, S), np.float32)}


def _loss_and_grads(name, auto_ctx, arch=None):
    """The port's loss, metrics and gradient leaves beside JAX's
    ``value_and_grad`` on one batch."""
    jcfg, tcfg, jp, _ = _model(name, arch)
    batch = _batch(jcfg.vocab)
    (jl, jm), jg = _jit(jax.value_and_grad(
        lambda p, b: jloss_fn(jcfg, p, b, auto_ctx), has_aux=True))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    tp = make_state(_model(name, arch)[3])["params"]
    loss, metrics = loss_fn(tcfg, tp, {k: torch.from_numpy(v)
                                       for k, v in batch.items()})
    grads = torch.autograd.grad(loss, tree_leaves(tp))
    jg = params_from_numpy(jax.tree.map(np.asarray, jg), tcfg, device="cpu")
    want = tree_leaves(tree_map(lambda _, g: g, tp, jg))   # in tp's order
    return (loss, metrics, grads), (jl, jm, want), tp


def _hold_grads(got, want, tp):
    (loss, metrics, grads), (jl, jm, jg) = got, want
    assert set(metrics) == set(jm)
    assert abs(loss.item() - float(jl)) <= LOSS_TOL * float(jl)
    if "moe_aux" in jm:
        assert abs(float(metrics["moe_aux"]) - float(jm["moe_aux"])) <= \
            LOSS_TOL * float(jm["moe_aux"])
    assert len(grads) == len(jg)
    for g, w, p in zip(grads, jg, tree_leaves(tp)):
        assert g.dtype == p.dtype and g.shape == p.shape
        assert _rel(g, w) < GRAD_TOL, (tuple(g.shape), _rel(g, w))


@pytest.mark.parametrize("name", list(VARIANTS))
def test_loss_and_grads_match_jax(name, auto_ctx):
    """The loss (``moe_aux`` too) and every gradient leaf within
    ``GRAD_TOL`` of the largest value of JAX's: the non-gated experts'
    up and down stacks through ``GroupedGemm``'s backward, the post-norm
    weights, the Mamba-1 scan's and Mamba-2 SSD's backwards."""
    got, want, tp = _loss_and_grads(name, auto_ctx)
    _hold_grads(got, want, tp)
