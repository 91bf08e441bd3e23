"""The port's paged serving path against the JAX fast paged engine on the
CPU: prefill rows and logits, one paged decode step, the page write, the
engine's greedy streams, sampling and the engine's bookkeeping.
Parameters come from the JAX initializer, inputs from numpy seeds."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import all_configs, smoke_config
from repro.models.model import model_defs
from repro.serve import decode as jdec
from repro.serve.engine import Request as JRequest
from repro.serve.engine import make_engine as jmake_engine
from repro.serve.prefill import prefill as jprefill
from repro.sharding import params as prm
from repro.sharding.axes import single_device_ctx
from repro_torch import configs as tconfigs
from repro_torch.params import params_from_numpy
from repro_torch.serve import decode as tdec
from repro_torch.serve import engine as teng
from repro_torch.serve.prefill import bucket_len, prefill

ARCH = "mistral-nemo-12b"
ATOL = 1e-4
BF16_REL = 3e-2          # the repo's bf16 logits tolerance (tests/test_serve)
LENS = [4, 5, 9, 17, 18, 23, 63]   # tests/test_serve.py engine workload


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


def _logits_close(got, want, dtype):
    got, want = got.numpy(), np.asarray(want)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=ATOL, atol=ATOL)
    else:
        rel = np.abs(got - want).max() / np.abs(want).max()
        assert rel < BF16_REL, rel


@pytest.mark.parametrize("bucket", [16, 32, 64])
def test_prefill_matches_jax(model, bucket):
    jcfg, tcfg, jp, tp = model
    rng = np.random.default_rng(bucket)
    lens = np.array([bucket // 2 + 1, bucket], np.int32)
    toks = np.zeros((2, bucket), np.int32)
    for i, n in enumerate(lens):
        toks[i, :n] = rng.integers(0, tcfg.vocab, n)
    ps = 8
    logits, cache = prefill(tcfg, tp, torch.from_numpy(toks),
                            prompt_len=torch.from_numpy(lens), page_size=ps)
    jlogits, jcache = jprefill(jcfg, jp, jnp.asarray(toks),
                               single_device_ctx(),
                               prompt_len=jnp.asarray(lens), page_size=ps)
    assert logits.dtype == torch.float32
    _logits_close(logits, jlogits, jcfg.param_dtype)
    if jcfg.param_dtype != "float32":
        return
    for i, layer in enumerate(cache["layers"]):
        for name in ("k", "v"):
            want = np.asarray(jcache["blocks"][0]["s0"][name][i])
            assert tuple(layer[name].shape) == want.shape
            np.testing.assert_allclose(layer[name].numpy(), want, rtol=ATOL,
                                       atol=ATOL)


def _paged_state(cfg, B=3, T=4, ps=8, seed=0):
    rng = np.random.default_rng(seed)
    N = 1 + B * T
    shape = (N, ps, cfg.n_kv_heads, cfg.head_dim)
    pools = [{n: rng.normal(size=shape).astype(np.float32) * 0.5
              for n in ("k", "v")} for _ in range(cfg.n_layers)]
    pt = (1 + rng.permutation(N - 1).reshape(B, T)).astype(np.int32)
    pos = np.array([5, 2 * ps + 3, T * ps], np.int32)   # last: frozen slot
    toks = rng.integers(0, cfg.vocab, B).astype(np.int32)
    return pools, pt, pos, toks


def test_decode_step_matches_jax(model):
    jcfg, tcfg, jp, tp = model
    pools, pt, pos, toks = _paged_state(tcfg)
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
                                       jnp.asarray(pos), single_device_ctx(),
                                       page_table=jnp.asarray(pt))
    assert logits.dtype == torch.float32
    _logits_close(logits, jlogits, jcfg.param_dtype)
    if jcfg.param_dtype != "float32":
        return
    for i, layer in enumerate(tcache["layers"]):
        for name in ("k", "v"):
            np.testing.assert_allclose(
                layer[name].numpy(),
                np.asarray(jcache["blocks"][0]["s0"][name][i]), rtol=ATOL,
                atol=ATOL)


def test_paged_write_routes_frozen_slot_to_trash_page():
    rng = np.random.default_rng(1)
    ps, T = 4, 3
    pool = rng.normal(size=(1 + 2 * T, ps, 2, 8)).astype(np.float32)
    row = rng.normal(size=(2, 2, 8)).astype(np.float32)
    pt = np.array([[1, 2, 3], [4, 5, 6]], np.int32)
    pos = np.array([6, T * ps], np.int32)              # slot 1 frozen
    got = tdec._paged_write(torch.from_numpy(pool.copy()),
                            torch.from_numpy(row), torch.from_numpy(pt),
                            torch.from_numpy(pos))
    want = jdec._paged_write(jnp.asarray(pool), jnp.asarray(row),
                             jnp.asarray(pt), jnp.asarray(pos), 0, 1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got[0, 0].numpy(), row[1])   # trash page
    np.testing.assert_array_equal(got[2, 2].numpy(), row[0])   # pos 6


def _prompts(cfg):
    rng = np.random.default_rng(3)
    return [rng.integers(0, cfg.vocab, n).tolist() for n in LENS]


ENGINE_KW = dict(max_slots=3, max_len=64, page_size=8, decode_quantum=4)


def _serve_both(jcfg, tcfg, tp, monkeypatch):
    prompts = _prompts(tcfg)
    jeng = jmake_engine(jcfg, single_device_ctx(), paged=True, **ENGINE_KW)
    jreqs = [JRequest(rid=i, prompt=p, max_new=1 if i == 1 else 6)
             for i, p in enumerate(prompts)]
    jeng.run(jreqs)
    fetches = []
    orig = teng._host_fetch
    monkeypatch.setattr(teng, "_host_fetch",
                        lambda x: fetches.append(1) or orig(x))
    eng = teng.Engine(tcfg, tp, device="cpu", **ENGINE_KW)
    reqs = [teng.Request(rid=i, prompt=p, max_new=1 if i == 1 else 6)
            for i, p in enumerate(prompts)]
    eng.run(reqs)
    return jreqs, reqs, eng, len(fetches)


def test_engine_greedy_streams_match_jax(model, monkeypatch):
    jcfg, tcfg, jp, tp = model
    jreqs, reqs, eng, n_fetch = _serve_both(jcfg, tcfg, tp, monkeypatch)
    assert all(r.done for r in reqs)
    assert [len(r.out) for r in reqs] == [6, 1, 6, 6, 6, 6, 2]
    eng.alloc.check()
    assert len(eng.alloc.free) == eng.alloc.usable_pages
    assert eng.alloc.total_grants > eng.alloc.usable_pages // 2
    assert n_fetch == eng.quanta + eng.prefill_groups
    same = [a.out == b.out for a, b in zip(jreqs, reqs)]
    if jcfg.param_dtype == "float32":
        assert all(same), [(a.out, b.out) for a, b in zip(jreqs, reqs)]
    else:   # bf16 rounds at other places in the two frameworks: report only
        print(f"bf16 greedy streams identical to JAX: {sum(same)}/"
              f"{len(same)}")


# --------------------------------------------------------------- sampling
@pytest.mark.parametrize("top_k,top_p", [(0, 0.0), (5, 0.0), (0, 0.9),
                                         (7, 0.8)])
def test_filter_logits_matches_jax(top_k, top_p):
    lg = np.random.default_rng(2).normal(size=(4, 512)).astype(np.float32)
    kw = dict(temperature=0.7, top_k=top_k, top_p=top_p)
    got = tdec._filter_logits(torch.from_numpy(lg), **kw)
    want = jdec._filter_logits(jnp.asarray(lg), **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_sampled_tokens_stay_in_top_k():
    lg = torch.from_numpy(
        np.random.default_rng(4).normal(size=(4, 512)).astype(np.float32))
    top = set()
    for b in range(4):
        top |= {(b, int(i)) for i in torch.topk(lg[b], 5).indices}
    gen = torch.Generator().manual_seed(0)
    seen = set()
    for _ in range(200):
        tok = tdec._sample_tokens(lg, gen, temperature=1.0, top_k=5)
        assert tok.dtype == torch.int32
        seen |= {(b, int(t)) for b, t in enumerate(tok)}
    assert seen <= top and len(seen) > 4
    greedy = tdec._sample_tokens(lg, gen, temperature=0.0, top_k=0)
    np.testing.assert_array_equal(greedy.numpy(), lg.argmax(-1).numpy())


def test_engine_sampling_seeds_and_greedy():
    _, tcfg = _cfgs("float32")
    from repro_torch.params import init_params
    tp = init_params(tcfg, seed=0, device="cpu")
    prompts = _prompts(tcfg)[:3]

    def serve(**kw):
        eng = teng.Engine(tcfg, tp, device="cpu", max_slots=2, max_len=64,
                          decode_quantum=4, page_size=8, **kw)
        reqs = [teng.Request(rid=i, prompt=p, max_new=8)
                for i, p in enumerate(prompts)]
        eng.run(reqs)
        return [r.out for r in reqs]

    greedy = serve()
    assert serve(temperature=0.7, top_k=1, sample_seed=5) == greedy
    a = serve(temperature=0.8, top_k=4, sample_seed=0)
    assert serve(temperature=0.8, top_k=4, sample_seed=0) == a
    assert serve(temperature=0.8, top_k=4, sample_seed=1) != a


# ----------------------------------------------------- engine bookkeeping
@pytest.fixture(scope="module")
def small_engine_args():
    _, tcfg = _cfgs("float32")
    from repro_torch.params import init_params
    return tcfg, init_params(tcfg, seed=0, device="cpu")


def test_engine_validation(small_engine_args):
    tcfg, tp = small_engine_args
    for bad in (dict(temperature=-0.1), dict(top_k=-1),
                dict(top_k=tcfg.vocab + 1), dict(top_p=1.5),
                dict(max_len=60, page_size=8)):
        with pytest.raises(ValueError):
            teng.Engine(tcfg, tp, device="cpu", **bad)
    eng = teng.Engine(tcfg, tp, device="cpu", max_len=64, page_size=8)
    with pytest.raises(teng.PromptTooLongError):
        eng.submit(teng.Request(rid=0, prompt=[1] * 64))
    with pytest.raises(ValueError):
        eng.submit(teng.Request(rid=1, prompt=[]))
    with pytest.raises(ValueError):
        bucket_len(65, max_bucket=64)
    # a front end's model is served as text; an encoder-decoder is refused
    # as by the JAX engine, which names whisper_decode_step
    assert teng.Engine(dataclasses.replace(tcfg, frontend="vision"), tp,
                       device="cpu").cfg.frontend == "vision"
    with pytest.raises(NotImplementedError, match="whisper_decode_step"):
        teng.Engine(dataclasses.replace(tcfg, enc_dec=True), tp,
                    device="cpu")


def test_engine_backpressure_abort_and_drain(small_engine_args):
    tcfg, tp = small_engine_args
    # pool of 1 + 8 pages: one 8-page context at a time
    eng = teng.Engine(tcfg, tp, device="cpu", max_slots=3, max_len=64,
                      page_size=8, num_pages=9, decode_quantum=4)
    prompts = _prompts(tcfg)
    reqs = [teng.Request(rid=i, prompt=p, max_new=40)
            for i, p in enumerate(prompts[3:6])]
    assert eng.plan_admission(reqs) == 1
    for r in reqs:
        eng.submit(r)
    eng.step()
    assert sum(r is not None for r in eng.slot_req) == 1
    assert len(eng.pending) == 2
    back = eng.abort()
    assert [r.rid for r in back] == [0] and back[0].out
    eng.alloc.check()
    assert len(eng.alloc.free) == eng.alloc.usable_pages
    assert [r.rid for r in eng.take_pending()] == [1, 2]
    again = [teng.Request(rid=7, prompt=prompts[0], max_new=3)]
    for r in again:
        eng.submit(r)
    eng.drain()
    assert again[0].done and len(again[0].out) == 3
    assert not eng.has_work()
