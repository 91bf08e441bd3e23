"""The port's MoE path on the CPU against the JAX package: the grouped GEMM's
plain version against the JAX reference and the Pallas kernel in interpret
mode, ``moe_block`` / ``moe_decode`` and the router stats (with and without
capacity dropping), and phi3.5-moe (GQA + MoE, no shared experts) through
prefill, one paged decode step and the engine's greedy streams. Parameters
come from the JAX initializer, inputs from numpy seeds."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import all_configs, smoke_config
from repro.configs.base import MoECfg as JMoECfg
from repro.configs.base import ModelConfig as JModelConfig
from repro.kernels.grouped_gemm.grouped_gemm import grouped_gemm as jgg
from repro.kernels.grouped_gemm.ref import grouped_gemm_ref as jgg_ref
from repro.models import moe as jmoe
from repro.models.model import model_defs
from repro.models.transformer import block_cfg_for_layer, layer_schedule
from repro.serve import decode as jdec
from repro.serve.engine import Request as JRequest
from repro.serve.engine import make_engine as jmake_engine
from repro.serve.prefill import prefill as jprefill
from repro.sharding import params as prm
from repro.sharding.axes import single_device_ctx
from repro_torch import configs as tconfigs
from repro_torch.configs.base import MoECfg, ModelConfig
from repro_torch.kernels.grouped_gemm import ops as gg_ops
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttr
from repro_torch.params import n_params, params_from_numpy
from repro_torch.serve import decode as tdec
from repro_torch.serve import engine as teng
from repro_torch.serve.prefill import prefill

F32_TOL = 1e-4           # tests/test_kernels.py grouped GEMM, f32
BF16_TOL = 3e-2          # and bf16
ATOL = 1e-4              # logits, as tests/test_torch_serve.py
ARCHS = ["deepseek-v2-236b", "phi3.5-moe-42b-a6.6b"]
PHI = "phi3.5-moe-42b-a6.6b"
LENS = [4, 5, 9, 17, 18, 23, 63]   # tests/test_serve.py engine workload
ENGINE_KW = dict(max_slots=3, max_len=64, page_size=8, decode_quantum=4)
# both engines admit with this HBB speed ratio: MoE capacity couples the
# rows of a prefill group, so identical streams need identical groups, and
# the measured ratio differs between the two frameworks' timings
PINNED_F = 0.01


def _torch(a, dtype=None):
    t = torch.from_numpy(np.array(a, np.float32))
    return t.to(dtype) if dtype is not None else t


# ------------------------------------------------------------ grouped GEMM
@pytest.mark.parametrize("E,M,K,N", [(4, 64, 128, 64), (8, 128, 256, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grouped_gemm_plain_matches_jax(E, M, K, N, dtype):
    rng = np.random.default_rng(E)
    a = rng.normal(size=(E, M, K)).astype(np.float32)
    w = rng.normal(size=(E, K, N)).astype(np.float32)
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    ja, jw = jnp.asarray(a).astype(dtype), jnp.asarray(w).astype(dtype)
    got = gg_ops.grouped_gemm(_torch(ja, tdt), _torch(jw, tdt))
    assert got.dtype == tdt and tuple(got.shape) == (E, M, N)
    tol = BF16_TOL if dtype == "bfloat16" else F32_TOL
    got = got.float().numpy()
    for want in (jgg_ref(ja, jw),
                 jgg(ja, jw, bm=32, bn=32, bk=64, interpret=True)):
        np.testing.assert_allclose(got, np.asarray(want, np.float32),
                                   rtol=tol, atol=tol)


def test_grouped_gemm_plain_broadcast_and_ragged():
    """Decode's stride-0 operand (one token block read by every expert) and
    a ragged M, against the JAX reference on the materialized operand."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(5, 32)).astype(np.float32)        # M = 5
    w = rng.normal(size=(6, 32, 24)).astype(np.float32)
    a = torch.from_numpy(x).unsqueeze(0).expand(6, 5, 32)
    assert a.stride(0) == 0
    got = gg_ops.grouped_gemm(a, torch.from_numpy(w))
    want = jgg_ref(jnp.broadcast_to(jnp.asarray(x), (6, 5, 32)),
                   jnp.asarray(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=F32_TOL,
                               atol=F32_TOL)


def test_grouped_gemm_plain_leaves_counter_and_refuses_other_devices():
    n0 = gg_ops.launches
    a = torch.ones((2, 3, 8))
    gg_ops.grouped_gemm(a, torch.ones((2, 8, 8)))
    assert gg_ops.launches == n0
    meta = torch.empty((2, 3, 8), device="meta")
    with pytest.raises(ValueError):
        gg_ops.grouped_gemm(meta, torch.empty((2, 8, 8), device="meta"))


# --------------------------------------------------------------- MoE block
def _moe_cfgs(E=8, k=2, cf=8.0, n_shared=0):
    """tests/test_moe.py's config, in both packages."""
    kw = dict(name="moe-test", family="moe", n_layers=2, d_model=32,
              n_heads=4, n_kv_heads=2, head_dim=8, d_ff=64, vocab=64,
              act="swiglu", param_dtype="float32")
    mk = dict(n_experts=E, top_k=k, d_expert=48, n_shared=n_shared,
              capacity_factor=cf)
    return (JModelConfig(moe=JMoECfg(**mk), **kw),
            ModelConfig(moe=MoECfg(**mk), **kw))


@pytest.fixture(scope="module")
def moe_tree():
    """One expert tree with a shared expert; without ``ws_*`` it is the
    tree of the same config with none."""
    jcfg, _ = _moe_cfgs(n_shared=1)
    return prm.materialize(jmoe.moe_defs(jcfg), jax.random.PRNGKey(0))


def _moe_params(tree, n_shared):
    jp = {n: v for n, v in tree.items() if n_shared or not n.startswith("ws")}
    return jp, {n: _torch(v) for n, v in jp.items()}


@pytest.mark.parametrize("cf,n_shared", [(16.0, 0), (16.0, 1), (0.1, 0),
                                         (1.25, 1)])
def test_moe_block_matches_jax(moe_tree, cf, n_shared):
    """cf 0.1 is tests/test_moe.py's capacity-dropping case; 1.25 the
    served configs' factor, which drops too at this size."""
    jcfg, tcfg = _moe_cfgs(cf=cf, n_shared=n_shared)
    jp, tp = _moe_params(moe_tree, n_shared)
    x = np.random.default_rng(2).normal(size=(2, 32, 32)).astype(np.float32)
    got, stats = tmoe.moe_block(tcfg, tp, torch.from_numpy(x))
    want, jstats = jax.jit(lambda p, x: jmoe.moe_block(
        jcfg, p, x, single_device_ctx()))(jp, jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=ATOL,
                               atol=ATOL)
    assert stats.dtype == torch.float32 and tuple(stats.shape) == (2, 8)
    np.testing.assert_allclose(stats.numpy(), np.asarray(jstats), rtol=1e-6,
                               atol=1e-6)
    Ce = tmoe.capacity(tcfg, 64)
    counts = torch.round(stats[1] * 64 * 2)          # routing slots per expert
    dropped = int((counts - Ce).clamp(min=0).sum())
    assert (dropped > 0) == (cf < 8), dropped


def test_capacity_counts_every_row():
    _, tcfg = _moe_cfgs(cf=1.25)
    assert tmoe.capacity(tcfg, 3 * 16) == 15     # ceil(48 · 2 · 1.25 / 8)
    assert tmoe.capacity(tcfg, 1) == 1


@pytest.mark.parametrize("n_shared", [0, 1])
def test_moe_decode_matches_jax(moe_tree, n_shared):
    jcfg, tcfg = _moe_cfgs(cf=1.25, n_shared=n_shared)
    jp, tp = _moe_params(moe_tree, n_shared)
    x = np.random.default_rng(3).normal(size=(4, 32)).astype(np.float32)
    got = tmoe.moe_decode(tcfg, tp, torch.from_numpy(x))
    want = jax.jit(lambda p, x: jmoe.moe_decode(
        jcfg, p, x, single_device_ctx()))(jp, jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=ATOL,
                               atol=ATOL)


# --------------------------------------------------- configs and parameters
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("smoke", [False, True])
def test_config_and_schedule_match_jax(arch, smoke):
    j, t = all_configs()[arch], tconfigs.get_config(arch)
    if smoke:
        j, t = smoke_config(j), tconfigs.smoke_config(t)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert [dataclasses.asdict(b) for b in ttr.block_cfgs(t)] == \
        [dataclasses.asdict(block_cfg_for_layer(j, i))
         for i in range(j.n_layers)]
    assert [(len(s.pattern), s.repeat) for s in ttr.layer_schedule(t)] == \
        [(len(s.pattern), s.repeat) for s in layer_schedule(j)]
    assert n_params(t) == prm.n_params(model_defs(j))


def test_check_supported_refuses_what_is_not_ported():
    """An encoder-decoder (served through whisper_decode_step instead) is
    refused; a front end is served (as text), and so is a non-gated MoE FFN
    (held against JAX in ``tests/test_torch_variants.py``), whose expert
    tree has no ``w_gate``."""
    t = tconfigs.smoke_config(tconfigs.get_config(PHI))
    with pytest.raises(NotImplementedError, match="whisper_decode_step"):
        ttr.check_supported(dataclasses.replace(t, enc_dec=True))
    ttr.check_supported(dataclasses.replace(t, frontend="vision"))
    relu2 = dataclasses.replace(t, act="relu2")
    ttr.check_supported(relu2)
    assert n_params(relu2) == prm.n_params(model_defs(dataclasses.replace(
        smoke_config(all_configs()[PHI]), act="relu2")))


# ------------------------------------------------- phi3.5-moe through serve
def _cfgs(arch, dtype="float32"):
    j = dataclasses.replace(smoke_config(all_configs()[arch]),
                            param_dtype=dtype)
    t = dataclasses.replace(tconfigs.smoke_config(tconfigs.get_config(arch)),
                            param_dtype=dtype)
    return j, t


@pytest.fixture(scope="module")
def phi():
    jcfg, tcfg = _cfgs(PHI)
    jp = prm.materialize(model_defs(jcfg), jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    return jcfg, tcfg, jp, tp


def test_params_from_numpy_carries_the_expert_stacks(phi):
    jcfg, tcfg, jp, tp = phi
    seg = jp["blocks"][0]["s0"]["moe"]
    for i, layer in enumerate(tp["layers"]):
        assert layer["moe"]["router"].dtype == torch.float32
        for n in ("router", "w_up", "w_gate", "w_down"):
            np.testing.assert_array_equal(layer["moe"][n].numpy(),
                                          np.asarray(seg[n][i]))


def test_phi_prefill_and_decode_step_match_jax(phi):
    jcfg, tcfg, jp, tp = phi
    rng = np.random.default_rng(4)
    lens = np.array([9, 16, 1], np.int32)             # a pad row, as served
    toks = np.zeros((3, 16), np.int32)
    for i, n in enumerate(lens):
        toks[i, :n] = rng.integers(0, tcfg.vocab, n)
    logits, cache = prefill(tcfg, tp, torch.from_numpy(toks),
                            prompt_len=torch.from_numpy(lens), page_size=8)
    jlogits, jcache = jprefill(jcfg, jp, jnp.asarray(toks),
                               single_device_ctx(),
                               prompt_len=jnp.asarray(lens), page_size=8)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               rtol=ATOL, atol=ATOL)
    for i, layer in enumerate(cache["layers"]):
        for n in ("k", "v"):
            np.testing.assert_allclose(
                layer[n].numpy(), np.asarray(jcache["blocks"][0]["s0"][n][i]),
                rtol=ATOL, atol=ATOL)
    # one paged decode step on random pools
    B, T, ps = 3, 4, 8
    N = 1 + B * T
    shape = (N, ps, tcfg.n_kv_heads, tcfg.head_dim)
    pools = [{n: rng.normal(size=shape).astype(np.float32) * 0.5
              for n in ("k", "v")} for _ in range(tcfg.n_layers)]
    pt = (1 + rng.permutation(N - 1).reshape(B, T)).astype(np.int32)
    pos = np.array([5, 2 * ps + 3, T * ps], np.int32)
    tok = rng.integers(0, tcfg.vocab, B).astype(np.int32)
    tcache = {"layers": [{n: torch.from_numpy(a.copy()) for n, a in l.items()}
                         for l in pools]}
    jc = {"blocks": [{"s0": {n: jnp.asarray(np.stack([l[n] for l in pools]))
                             for n in ("k", "v")}}]}
    got, _ = tdec.decode_step(tcfg, tp, tcache, torch.from_numpy(tok),
                              torch.from_numpy(pos), torch.from_numpy(pt))
    want, _ = jdec.decode_step(jcfg, jp, jc, jnp.asarray(tok),
                               jnp.asarray(pos), single_device_ctx(),
                               page_table=jnp.asarray(pt))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=ATOL,
                               atol=ATOL)


def serve_both(arch, jcfg, tcfg, tp, monkeypatch):
    """Serve the tests/test_serve.py workload through the JAX fast paged
    engine and the port's engine, both admitting at ``PINNED_F``."""
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, tcfg.vocab, n).tolist() for n in LENS]
    jeng = jmake_engine(jcfg, single_device_ctx(), paged=True, **ENGINE_KW)
    monkeypatch.setattr(jeng.tracker, "f", lambda: PINNED_F)
    jreqs = [JRequest(rid=i, prompt=p, max_new=1 if i == 1 else 6)
             for i, p in enumerate(prompts)]
    jeng.run(jreqs)
    eng = teng.Engine(tcfg, tp, device="cpu", **ENGINE_KW)
    monkeypatch.setattr(eng.tracker, "f", lambda: PINNED_F)
    reqs = [teng.Request(rid=i, prompt=p, max_new=1 if i == 1 else 6)
            for i, p in enumerate(prompts)]
    eng.run(reqs)
    assert all(r.done for r in reqs)
    assert [len(r.out) for r in reqs] == [6, 1, 6, 6, 6, 6, 2]
    eng.alloc.check()
    assert len(eng.alloc.free) == eng.alloc.usable_pages
    assert eng.prefill_groups == jeng.prefill_groups
    return jreqs, reqs


def test_phi_engine_greedy_streams_match_jax(phi, monkeypatch):
    jcfg, tcfg, _, tp = phi
    jreqs, reqs = serve_both(PHI, jcfg, tcfg, tp, monkeypatch)
    assert [r.out for r in reqs] == [r.out for r in jreqs]
