"""The port's non-gated FFN (relu2 and gelu, no ``w_gate``) against the JAX
package on the nemotron-4-15b smoke config on the CPU: the activations and
``mlp``, the parameter tree, prefill logits and cache rows, one paged
decode step, the paged engine's greedy streams against the JAX fast paged
engine, and the training loss and gradients against
``jax.value_and_grad(loss_fn)``. Parameters come from the JAX initializer,
inputs from numpy seeds."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import all_configs, smoke_config
from repro.models import layers as jl
from repro.models.model import loss_fn as jloss_fn
from repro.models.model import model_defs
from repro.serve import decode as jdec
from repro.serve.engine import Request as JRequest
from repro.serve.engine import make_engine as jmake_engine
from repro.serve.prefill import prefill as jprefill
from repro.sharding import params as prm
from repro_torch import configs as tconfigs
from repro_torch.models import layers as tl
from repro_torch.models.model import loss_fn
from repro_torch.params import (n_params, param_specs, params_from_numpy,
                                tree_leaves)
from repro_torch.serve import decode as tdec
from repro_torch.serve import engine as teng
from repro_torch.serve.prefill import prefill
from repro_torch.train.step import make_state

ARCH = "nemotron-4-15b"
ATOL = 1e-4              # f32, as tests/test_torch_serve.py
BF16_REL = 3e-2          # bf16 logits, relative to the largest
GRAD_TOL = {"float32": 1e-4, "bfloat16": 3e-2}
LOSS_TOL = {"float32": 1e-5, "bfloat16": 1e-3}
LENS = [4, 5, 9, 17, 18, 23, 63]   # tests/test_serve.py engine workload


def _cfgs(dtype, **extra):
    j = dataclasses.replace(smoke_config(all_configs()[ARCH]),
                            param_dtype=dtype, **extra)
    t = dataclasses.replace(tconfigs.smoke_config(tconfigs.get_config(ARCH)),
                            param_dtype=dtype, **extra)
    return j, t


def _port(tree, tcfg):
    return params_from_numpy(jax.tree.map(np.asarray, tree), tcfg,
                             device="cpu")


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def model(request):
    jcfg, tcfg = _cfgs(request.param)
    jp = prm.materialize(model_defs(jcfg), jax.random.PRNGKey(0))
    return jcfg, tcfg, jp, _port(jp, tcfg)


def _close(got, want, dtype):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=ATOL, atol=ATOL)
    else:
        rel = np.abs(got - want).max() / np.abs(want).max()
        assert rel < BF16_REL, rel


# ------------------------------------------------------------ activations
@pytest.mark.parametrize("act", ["relu2", "gelu"])
def test_activation_matches_jax(act):
    x = np.random.default_rng(0).normal(size=(4, 257)).astype(np.float32) * 3
    got = tl.activation(act)(torch.from_numpy(x))
    want = jl.activation(act)(jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    assert not tl.is_gated(act) and tl.is_gated("swiglu")
    with pytest.raises(ValueError):
        tl.activation("geglu")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", ["relu2", "gelu"])
def test_mlp_matches_jax(ctx, act, dtype):
    """The non-gated MLP (up, activation, down) against JAX ``mlp`` on the
    nemotron smoke width, in f32 at 1e-4 and bf16 at 3e-2 relative."""
    jcfg, tcfg = _cfgs(dtype, act=act)
    jp = prm.materialize(model_defs(jcfg), jax.random.PRNGKey(0))
    tp = _port(jp, tcfg)
    assert "w_gate" not in tp["layers"][0]["mlp"]
    x = np.random.default_rng(1).normal(size=(2, 8, jcfg.d_model))
    jx = jnp.asarray(x, jnp.float32).astype(jcfg.pdtype)
    tx = torch.from_numpy(x.astype(np.float32)).to(tcfg.pdtype)
    want = jl.mlp(jcfg, jax.tree.map(lambda a: a[0], jp["blocks"][0]["s0"])
                  ["mlp"], jx, ctx)
    got = tl.mlp(tcfg, tp["layers"][0]["mlp"], tx)
    assert got.dtype == tcfg.pdtype
    _close(got.float().numpy(), np.asarray(want, np.float32), dtype)


def test_param_tree_has_no_gate():
    """No ``w_gate`` in a non-gated FFN; the leaf count and the parameter
    count equal JAX's tree at full width and at smoke size."""
    for cfg_fn in (lambda n: all_configs()[n],
                   lambda n: smoke_config(all_configs()[n])):
        jcfg = cfg_fn(ARCH)
        tcfg = tconfigs.get_config(ARCH)
        if "smoke" in jcfg.name:
            tcfg = tconfigs.smoke_config(tcfg)
        specs = param_specs(tcfg)
        assert all("w_gate" not in layer["mlp"] for layer in specs["layers"])
        assert n_params(tcfg) == prm.n_params(model_defs(jcfg))
    assert n_params(tconfigs.get_config(ARCH)) == 15_628_376_064


# ------------------------------------------------------- prefill / decode
@pytest.mark.parametrize("bucket", [16, 64])
def test_prefill_matches_jax(ctx, model, bucket):
    jcfg, tcfg, jp, tp = model
    rng = np.random.default_rng(bucket)
    lens = np.array([bucket // 2 + 1, bucket], np.int32)
    toks = np.zeros((2, bucket), np.int32)
    for i, n in enumerate(lens):
        toks[i, :n] = rng.integers(0, tcfg.vocab, n)
    ps = 8
    logits, cache = prefill(tcfg, tp, torch.from_numpy(toks),
                            prompt_len=torch.from_numpy(lens), page_size=ps)
    jlogits, jcache = jprefill(jcfg, jp, jnp.asarray(toks), ctx,
                               prompt_len=jnp.asarray(lens), page_size=ps)
    assert logits.dtype == torch.float32
    _close(logits.numpy(), jlogits, jcfg.param_dtype)
    if jcfg.param_dtype != "float32":
        return
    for i, layer in enumerate(cache["layers"]):
        for name in ("k", "v"):
            want = np.asarray(jcache["blocks"][0]["s0"][name][i])
            assert tuple(layer[name].shape) == want.shape
            np.testing.assert_allclose(layer[name].numpy(), want, rtol=ATOL,
                                       atol=ATOL)


def test_paged_decode_step_matches_jax(ctx, model):
    jcfg, tcfg, jp, tp = model
    rng = np.random.default_rng(0)
    B, T, ps = 3, 4, 8
    N = 1 + B * T
    shape = (N, ps, tcfg.n_kv_heads, tcfg.head_dim)
    pools = [{n: rng.normal(size=shape).astype(np.float32) * 0.5
              for n in ("k", "v")} for _ in range(tcfg.n_layers)]
    pt = (1 + rng.permutation(N - 1).reshape(B, T)).astype(np.int32)
    pos = np.array([5, 2 * ps + 3, T * ps], np.int32)   # last: frozen slot
    toks = rng.integers(0, tcfg.vocab, B).astype(np.int32)
    dt = tcfg.pdtype
    tcache = {"layers": [{n: torch.from_numpy(a).to(dt) for n, a in l.items()}
                         for l in pools]}
    jcache = {"blocks": [{"s0": {
        n: jnp.asarray(np.stack([l[n] for l in pools])).astype(jcfg.pdtype)
        for n in ("k", "v")}}]}
    logits, tcache = tdec.decode_step(tcfg, tp, tcache, torch.from_numpy(toks),
                                      torch.from_numpy(pos),
                                      torch.from_numpy(pt))
    jlogits, jcache = jdec.decode_step(jcfg, jp, jcache, jnp.asarray(toks),
                                       jnp.asarray(pos), ctx,
                                       page_table=jnp.asarray(pt))
    _close(logits.numpy(), jlogits, jcfg.param_dtype)
    if jcfg.param_dtype != "float32":
        return
    for i, layer in enumerate(tcache["layers"]):
        for name in ("k", "v"):
            np.testing.assert_allclose(
                layer[name].numpy(),
                np.asarray(jcache["blocks"][0]["s0"][name][i]), rtol=ATOL,
                atol=ATOL)


# ---------------------------------------------------------------- engine
def test_engine_greedy_streams_match_jax(ctx, model, monkeypatch):
    """The port's paged engine against the JAX fast paged engine: identical
    greedy streams in f32 (bf16 rounds at other places in the two
    frameworks: the share that agrees is reported), one host read per
    quantum and per prefill group, the pool whole after the run."""
    jcfg, tcfg, jp, tp = model
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, tcfg.vocab, n).tolist() for n in LENS]
    kw = dict(max_slots=3, max_len=64, page_size=8, decode_quantum=4)
    jeng = jmake_engine(jcfg, ctx, paged=True, **kw)
    jreqs = [JRequest(rid=i, prompt=p, max_new=1 if i == 1 else 6)
             for i, p in enumerate(prompts)]
    jeng.run(jreqs)
    fetches = []
    orig = teng._host_fetch
    monkeypatch.setattr(teng, "_host_fetch",
                        lambda x: fetches.append(1) or orig(x))
    eng = teng.Engine(tcfg, tp, device="cpu", **kw)
    reqs = [teng.Request(rid=i, prompt=p, max_new=1 if i == 1 else 6)
            for i, p in enumerate(prompts)]
    eng.run(reqs)
    assert all(r.done for r in reqs)
    assert [len(r.out) for r in reqs] == [6, 1, 6, 6, 6, 6, 2]
    eng.alloc.check()
    assert len(eng.alloc.free) == eng.alloc.usable_pages
    assert len(fetches) == eng.quanta + eng.prefill_groups
    same = [a.out == b.out for a, b in zip(jreqs, reqs)]
    if jcfg.param_dtype == "float32":
        assert all(same), [(a.out, b.out) for a, b in zip(jreqs, reqs)]
    else:
        print(f"bf16 greedy streams identical to JAX: {sum(same)}/"
              f"{len(same)}")


# -------------------------------------------------------------- training
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_loss_and_grads_match_jax(ctx, dtype):
    """Loss and every gradient leaf through the port's training stack
    (``check_trainable`` admits relu2) against
    ``jax.value_and_grad(loss_fn)`` on ``materialize(model_defs(cfg))``."""
    jcfg, tcfg = _cfgs(dtype)
    jp = prm.materialize(model_defs(jcfg), jax.random.PRNGKey(0))
    toks = np.random.default_rng(0).integers(0, jcfg.vocab, (4, 33))
    toks = toks.astype(np.int32)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:],
             "mask": np.ones((4, 32), np.float32)}
    (jloss, _), jg = jax.jit(jax.value_and_grad(
        lambda p, b: jloss_fn(jcfg, p, b, ctx), has_aux=True))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    tp = make_state(_port(jp, tcfg))["params"]
    loss, _ = loss_fn(tcfg, tp, {k: torch.from_numpy(v)
                                 for k, v in batch.items()})
    grads = torch.autograd.grad(loss, tree_leaves(tp))
    assert abs(loss.item() - float(jloss)) <= LOSS_TOL[dtype] * float(jloss)
    for g, w in zip(grads, tree_leaves(_port(jg, tcfg))):
        err = float((g.float() - w.float()).abs().max() /
                    w.float().abs().max())
        assert err < GRAD_TOL[dtype], (tuple(g.shape), err)
