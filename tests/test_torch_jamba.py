"""jamba-v0.1-52b in the port against the JAX package on the CPU, at its
smoke config (8 layers: Mamba-1 mixers with attention at slot 4, MoE of 8
experts top-2 on the odd slots and dense SwiGLU FFNs on the even ones, d
64, chunk 32), in f32 so that both frameworks route every token alike:
the config and parameter tree, ``lm_hidden``, prefill logits and cache,
decode logits, the cache layouts, the admit, and greedy streams of the
paged and the dense engine against the JAX fast engine. The JAX side
runs on a 1×1 mesh with Auto axes: on the default Explicit-axis mesh
JAX's exact-length prefill of a hybrid raises a ``ShardingTypeError``
(``repro/models/attention.py:213``). Parameters come from the JAX
initializer, inputs from numpy seeds."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

from repro.configs import all_configs, smoke_config
from repro.models.model import model_defs
from repro.models.transformer import layer_schedule as jlayer_schedule
from repro.models.transformer import lm_hidden as jlm_hidden
from repro.serve import decode as jdec
from repro.serve import prefill as jpre
from repro.serve.engine import Request as JRequest
from repro.serve.engine import make_engine as jmake_engine
from repro.sharding import params as prm
from repro.sharding.axes import ShardCtx
from repro_torch import configs as tconfigs
from repro_torch.models import transformer as ttr
from repro_torch.models.draft import draft_from_target
from repro_torch.models.transformer import layer_schedule, lm_hidden
from repro_torch.params import (init_params, n_params, params_from_numpy,
                                tree_map)
from repro_torch.serve import engine as teng
from repro_torch.serve.decode import decode_step
from repro_torch.serve.kv_cache import cache_kinds, paged_cache_defs
from repro_torch.serve.prefill import prefill

ARCH = "jamba-v0.1-52b"
ATOL = 1e-4              # f32 logits and states, as tests/test_torch_serve.py
LENS = [5, 11, 19]       # the JAX probe's prompts, each shorter than a chunk
ENGINE_KW = dict(max_slots=3, max_len=48, page_size=8)
PINNED_F = 0.05          # both engines admit at one fixed HBB speed ratio


@pytest.fixture(scope="module")
def auto_ctx():
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         devices=jax.devices()[:1],
                         axis_types=(AxisType.Auto, AxisType.Auto))
    return ShardCtx(mesh=mesh)


@pytest.fixture(scope="module")
def model():
    jcfg = dataclasses.replace(smoke_config(all_configs()[ARCH]),
                               param_dtype="float32")
    tcfg = dataclasses.replace(tconfigs.smoke_config(
        tconfigs.get_config(ARCH)), param_dtype="float32")
    jp = prm.materialize(model_defs(jcfg), jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    return jcfg, tcfg, jp, tp


def _unstack(tcfg, blocks) -> list:
    """A JAX tree of stacked segments (params or cache ``blocks``) as one
    entry per layer, in layer order."""
    out = []
    for seg, tree in zip(layer_schedule(tcfg), blocks):
        for r in range(seg.repeat):
            for j in range(len(seg.pattern)):
                out.append(jax.tree.map(lambda a, r=r: np.asarray(a)[r],
                                        tree[f"s{j}"]))
    return out


def jax_params(cfg, tp):
    """The port's parameter tree as the JAX package's: layers stacked into
    the scan segments of ``layer_schedule`` (the inverse of
    ``params_from_numpy``), f32 leaves. Quicker than ``prm.materialize``,
    which traces each leaf's init (~11 s for jamba smoke)."""
    def arr(*ts):
        return jnp.asarray(np.stack([t.numpy() for t in ts]))
    blocks, i = [], 0
    for seg in layer_schedule(cfg):
        n = len(seg.pattern)
        blocks.append({f"s{j}": tree_map(arr, *[tp["layers"][i + r * n + j]
                                               for r in range(seg.repeat)])
                       for j in range(n)})
        i += n * seg.repeat
    flat = {k: tree_map(lambda t: jnp.asarray(t.numpy()), tp[k])
            for k in ("embed", "final_norm", "unembed")}
    return {**flat, "blocks": blocks}


def _close(got, want, tol=ATOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def _tokens(vocab, shape, seed):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


# ---------------------------------------------------------------- config
def test_config_and_params_match_jax(model):
    jcfg, tcfg, _, tp = model
    full_j, full_t = all_configs()[ARCH], tconfigs.get_config(ARCH)
    assert dataclasses.asdict(full_t) == dataclasses.asdict(full_j)
    for cut in (None, 8):
        j = full_j if cut is None else dataclasses.replace(full_j,
                                                           n_layers=cut)
        t = full_t if cut is None else dataclasses.replace(full_t,
                                                           n_layers=cut)
        assert n_params(t) == prm.n_params(model_defs(j))
    assert n_params(tcfg) == prm.n_params(model_defs(jcfg))
    # the smoke model: one whole period of every kind of layer
    assert (tcfg.n_layers, tcfg.d_model, tcfg.moe.n_experts,
            tcfg.ssm.chunk) == (8, 64, 8, 32)
    assert [([dataclasses.astuple(b) for b in s.pattern], s.repeat)
            for s in layer_schedule(tcfg)] == \
        [([dataclasses.astuple(b) for b in s.pattern], s.repeat)
         for s in jlayer_schedule(jcfg)]
    kinds = [(bc.mixer, bc.ffn) for bc in ttr.block_cfgs(tcfg)]
    assert kinds == [("mamba", "dense"), ("mamba", "moe")] * 2 + \
        [("attn", "dense"), ("mamba", "moe"), ("mamba", "dense"),
         ("mamba", "moe")]
    # the seeded initializer: JAX's inits and dtypes on the Mamba-1 leaves
    bf = dataclasses.replace(tcfg, param_dtype="bfloat16")
    m = init_params(bf, device="cpu")["layers"][0]["mamba"]
    r = -(-tcfg.d_model // 16)
    assert m["w_bcdt"].shape == (tcfg.d_inner, r + 2 * tcfg.ssm.d_state)
    assert m["w_dt"].shape == (r, tcfg.d_inner)
    assert m["wx"].dtype == torch.bfloat16
    for name, fill in (("A_log", 0.0), ("dt_bias", 0.0), ("D_skip", 1.0),
                       ("conv_x_b", 0.0)):
        assert torch.equal(m[name], torch.full_like(m[name], fill)), name
    assert m["A_log"].dtype == m["D_skip"].dtype == torch.float32
    assert m["A_log"].shape == (tcfg.d_inner, tcfg.ssm.d_state)
    assert set(tp["layers"][1]) == {"norm1", "mamba", "norm2", "moe"}
    assert set(tp["layers"][4]) == {"norm1", "attn", "norm2", "mlp"}


# ------------------------------------------------------------- forward
def test_lm_hidden_matches_jax(model, auto_ctx):
    """The stack's hidden states and summed router stats over 40 tokens
    (a padded second chunk)."""
    jcfg, tcfg, jp, tp = model
    toks = _tokens(tcfg.vocab, (2, 40), 1)
    with torch.no_grad():
        h, stats = lm_hidden(tcfg, tp, torch.from_numpy(toks))
    jh, jstats = jlm_hidden(jcfg, jp, jnp.asarray(toks), auto_ctx)
    _close(h, jh)
    _close(stats, jstats)


def test_prefill_and_decode_match_jax(model, auto_ctx):
    """Prefill logits and every layer's cache (Mamba-1 conv and SSM state,
    the attention layer's K/V rows) on the dense layout, then three decode
    steps from each package's own cache: logits against JAX's."""
    jcfg, tcfg, jp, tp = model
    S, max_len = 19, 32
    toks = _tokens(tcfg.vocab, (2, S + 3), 2)
    logits, cache = prefill(tcfg, tp, torch.from_numpy(toks[:, :S]),
                            max_len=max_len)
    jlogits, jcache = jpre.prefill(jcfg, jp, jnp.asarray(toks[:, :S]),
                                   auto_ctx, max_len=max_len)
    _close(logits, jlogits)
    for i, (layer, jlayer) in enumerate(zip(
            cache["layers"], _unstack(tcfg, jcache["blocks"]))):
        assert set(layer) == set(jlayer), i
        for name, t in layer.items():
            assert tuple(t.shape) == jlayer[name].shape, (i, name)
            _close(t, jlayer[name])
    for k in range(3):
        pos = np.full(2, S + k, np.int32)
        got, cache = decode_step(tcfg, tp, cache,
                                 torch.from_numpy(toks[:, S + k]),
                                 torch.from_numpy(pos))
        want, jcache = jdec.decode_step(jcfg, jp, jcache,
                                        jnp.asarray(toks[:, S + k]),
                                        jnp.asarray(pos), auto_ctx)
        _close(got, want)


def test_prefill_then_decode_equals_longer_prefill(model):
    """prefill(S) + one paged decode step of token S ≡ prefill(S + 1) at S
    = 40 (the Mamba layers' state crosses a padded chunk; the attention
    layer's rows go through the page table)."""
    _, tcfg, _, tp = model
    S, ps = 40, 8
    toks = torch.from_numpy(_tokens(tcfg.vocab, (1, S + 1), 3))
    want, _ = prefill(tcfg, tp, toks)
    _, rows = prefill(tcfg, tp, toks[:, :S], page_size=ps)
    T = -(-(S + 1) // ps)
    layers = []
    for kind, layer in zip(cache_kinds(tcfg), rows["layers"]):
        if kind == "dense":
            layers.append(layer)
            continue
        pool = {}
        for name, r in layer.items():
            p = r.new_zeros((1 + T, ps) + tuple(r.shape[2:]))
            p[1:1 + S // ps] = r[0].reshape((S // ps, ps) +
                                            tuple(r.shape[2:]))
            pool[name] = p
        layers.append(pool)
    table = torch.arange(1, 1 + T, dtype=torch.int32)[None]
    got, _ = decode_step(tcfg, tp, {"layers": layers}, toks[:, S],
                         torch.tensor([S], dtype=torch.int32), table)
    _close(got, want.numpy())


# ---------------------------------------------------------------- caches
def test_cache_layout_pages_attention_and_keeps_state_dense(model):
    """tests/test_paged.py's hybrid layout: the attention layer's K/V in
    the page pool, every Mamba-1 layer's conv tail (slots, d_conv - 1, C)
    in the parameter dtype and SSM state (slots, C, N) in f32, per slot."""
    _, tcfg, _, _ = model
    bf = dataclasses.replace(tcfg, param_dtype="bfloat16")
    defs = paged_cache_defs(bf, num_pages=9, page_size=8, max_slots=3,
                            max_len=48)
    kinds = cache_kinds(bf)
    assert kinds == ["dense"] * 4 + ["paged"] + ["dense"] * 3
    assert cache_kinds(bf, paged=False) == ["dense"] * 8
    for kind, layer in zip(kinds, defs["layers"]):
        if kind == "paged":
            assert set(layer) == {"k", "v"}
            assert layer["k"].shape == (9, 8, bf.n_kv_heads, bf.head_dim)
            continue
        assert layer["conv_x"].shape == (3, bf.ssm.d_conv - 1, bf.d_inner)
        assert layer["conv_x"].dtype == torch.bfloat16
        assert layer["ssm"].shape == (3, bf.d_inner, bf.ssm.d_state)
        assert layer["ssm"].dtype == torch.float32


def test_engine_admit_scatters_state_and_pages(model):
    """The admit writes each Mamba-1 layer's prefill state into the
    request's slot (no other slot changes) and the attention layer's rows
    into the pool pages its table grants."""
    _, tcfg, _, tp = model
    eng = teng.Engine(tcfg, tp, device="cpu", **ENGINE_KW)
    assert eng.pad_safe is False
    before = tree_map(lambda t: t.clone(), eng.cache)
    prompt = list(range(1, 12))
    eng.submit(teng.Request(rid=0, prompt=prompt, max_new=4))
    eng._admit_pending(eng.free_slots())
    slot = next(i for i, r in enumerate(eng.slot_req) if r is not None)
    _, rows = prefill(tcfg, tp, torch.tensor([prompt], dtype=torch.int32),
                      page_size=8)
    other = [i for i in range(eng.max_slots) if i != slot]
    pages = eng.alloc.table[slot, :2]
    for kind, layer, old, new in zip(eng.kinds, eng.cache["layers"],
                                     before["layers"], rows["layers"]):
        for name, t in layer.items():
            if kind == "dense":
                _close(t[slot], new[name][0].numpy(), 1e-6)
                assert torch.equal(t[other], old[name][other])
            else:
                got = t[torch.from_numpy(pages.astype(np.int64))]
                _close(got.reshape(16, *t.shape[2:])[:len(prompt)],
                       new[name][0, :len(prompt)].numpy(), 1e-6)


# ---------------------------------------------------------------- engine
@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
def test_engine_greedy_streams_match_jax(model, auto_ctx, paged,
                                         monkeypatch):
    """Prompts of 5, 11 and 19 tokens, 6 new tokens each, through the JAX
    fast engine and the port's, both admitting at ``PINNED_F``: the same
    exact-length groups, token-identical greedy streams."""
    jcfg, tcfg, _, tp = model
    prompts = [_tokens(tcfg.vocab, n, 10 + n).tolist() for n in LENS]
    jeng = jmake_engine(jcfg, auto_ctx, fast=True, paged=paged, **ENGINE_KW)
    monkeypatch.setattr(jeng.tracker, "f", lambda: PINNED_F)
    jreqs = [JRequest(rid=i, prompt=p, max_new=6)
             for i, p in enumerate(prompts)]
    jeng.run(jreqs)
    eng = teng.Engine(tcfg, tp, device="cpu", paged=paged, **ENGINE_KW)
    monkeypatch.setattr(eng.tracker, "f", lambda: PINNED_F)
    reqs = [teng.Request(rid=i, prompt=p, max_new=6)
            for i, p in enumerate(prompts)]
    eng.run(reqs)
    assert eng.pad_safe is False and jeng.pad_safe is False
    assert all(r.done and len(r.out) == 6 for r in reqs)
    assert eng.prefill_groups == jeng.prefill_groups
    if paged:
        eng.alloc.check()
        assert len(eng.alloc.free) == eng.alloc.usable_pages
    assert [r.out for r in reqs] == [r.out for r in jreqs], \
        [(a.out, b.out) for a, b in zip(jreqs, reqs)]


# ------------------------------------------------------------- refusals
def test_training_and_spec_decode_are_refused(model, monkeypatch):
    """Training Mamba-1 and hybrids is accepted (held against JAX in
    ``tests/test_torch_train_hybrid.py``), and so is speculative decode with
    a Mamba-1 target: the engine takes an independent draft (held against
    JAX in ``tests/test_torch_spec_mamba1.py``). Still refused:
    ``draft_from_target`` of a hybrid schedule (as JAX's), and, without a
    card, every entry point not given ``device="cpu"``."""
    _, tcfg, _, tp = model
    ttr.check_trainable(tcfg)
    draft = dataclasses.replace(tconfigs.smoke_config(tconfigs.get_config(
        "mistral-nemo-12b")), param_dtype="float32")
    assert draft.vocab == tcfg.vocab
    eng = teng.Engine(tcfg, tp, device="cpu", draft_cfg=draft, spec_k=2,
                      **ENGINE_KW)
    assert eng.spec and eng.tokens_per_step == 3
    with pytest.raises(ValueError):
        draft_from_target(tcfg, tp, 1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_params(tcfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        teng.Engine(tcfg, tp, **ENGINE_KW)
