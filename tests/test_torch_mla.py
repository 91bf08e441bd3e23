"""The port's MLA path on the CPU against the JAX package: the paged MLA
decode op's plain version against the JAX reference and the Pallas kernel
in interpret mode, the latent and query projections, deepseek-v2 smoke
(MLA + MoE with a shared expert, first layer dense) through prefill (logits
and ``ckv`` rows), one paged MLA decode step, and the engine's greedy
streams. Parameters come from the JAX initializer, inputs from numpy
seeds."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import all_configs, smoke_config
from repro.kernels.paged_attention import ref as jax_paged_ref
from repro.kernels.paged_attention.paged_attention import \
    paged_flash_decode_mla
from repro.models import attention as jattn
from repro.models.model import model_defs
from repro.serve import decode as jdec
from repro.serve.prefill import prefill as jprefill
from repro.sharding import params as prm
from repro.sharding.axes import single_device_ctx
from repro_torch import configs as tconfigs
from repro_torch.kernels.paged_attention import ops as paged_ops
from repro_torch.models import attention as tattn
from repro_torch.params import params_from_numpy
from repro_torch.serve import decode as tdec
from repro_torch.serve.kv_cache import paged_cache_defs
from repro_torch.serve.prefill import prefill
from test_torch_moe import serve_both

ARCH = "deepseek-v2-236b"
F32_TOL = 2e-5
ATOL = 1e-4              # logits and cache rows, as tests/test_torch_serve


# ---------------------------------------------------------- paged MLA op
def _mla_case(page_size, seed=0, H=4, kv_lora=32, rope=8, B=3, T=4):
    """Random latent pool, a disjoint-page table, multi-page positions and
    garbage in the trash page 0 (which no live slot points at)."""
    rng = np.random.default_rng(seed)
    R = kv_lora + rope
    N = 1 + B * T
    q = rng.normal(size=(B, H, R)).astype(np.float32)
    pool = rng.normal(size=(N, page_size, R)).astype(np.float32)
    pool[0] = 1e4                                  # trash page: must not leak
    pt = (1 + rng.permutation(N - 1)[:B * T].reshape(B, T)).astype(np.int32)
    pos = np.asarray([page_size - 1, 2 * page_size, T * page_size - 1][:B],
                     np.int32)
    return q, pool, pt, pos


@pytest.mark.parametrize("page_size", [8, 16])
@pytest.mark.parametrize("base_frac", [0, 2])
def test_paged_mla_plain_matches_jax(page_size, base_frac):
    q, pool, pt, pos = _mla_case(page_size)
    base = page_size // base_frac if base_frac else 0
    kw = dict(page_size=page_size, kv_lora=32, scale=0.2)
    n0 = paged_ops.mla_launches
    got = paged_ops.paged_attend_mla(*map(torch.from_numpy, (q, pool, pt, pos)),
                                     base, **kw)
    assert paged_ops.mla_launches == n0            # the plain version
    jcase = [jnp.asarray(a) for a in (q, pool, pt, pos)]
    want_ref = jax_paged_ref.paged_flash_decode_mla_ref(*jcase, base, **kw)
    want_kernel = paged_flash_decode_mla(*jcase, base, interpret=True, **kw)
    for g, wr, wk in zip(got, want_ref, want_kernel):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(wr), rtol=F32_TOL,
                                   atol=F32_TOL)
        np.testing.assert_allclose(g.numpy(), np.asarray(wk), rtol=F32_TOL,
                                   atol=F32_TOL)
    assert np.abs(got[0].numpy()).max() < 1e3      # trash page never read


@pytest.mark.parametrize("shard", [0, 1])
def test_paged_mla_plain_shard_local_pool(shard):
    """A pool holding one model shard's half of every page (ps_loc =
    page_size / 2, base = shard · ps_loc), the JAX kernel's sharded
    contract."""
    q, pool, pt, pos = _mla_case(16, seed=1)
    pool = np.ascontiguousarray(pool[:, shard * 8:(shard + 1) * 8])
    kw = dict(page_size=16, kv_lora=32, scale=0.2)
    got = paged_ops.paged_attend_mla(*map(torch.from_numpy, (q, pool, pt, pos)),
                                     shard * 8, **kw)
    want = paged_flash_decode_mla(*map(jnp.asarray, (q, pool, pt, pos)),
                                  shard * 8, interpret=True, **kw)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=F32_TOL,
                                   atol=F32_TOL)


def test_paged_mla_wrapper_refuses_other_devices():
    meta = torch.empty((1, 4, 40), device="meta")
    pool = torch.empty((2, 8, 40), device="meta")
    idx = torch.zeros((1, 1), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        paged_ops.paged_attend_mla(meta, pool, idx, idx[:, 0], page_size=8,
                                   kv_lora=32, scale=0.1)


# ------------------------------------------------------ deepseek-v2 smoke
def _cfgs(dtype="float32"):
    j = dataclasses.replace(smoke_config(all_configs()[ARCH]),
                            param_dtype=dtype)
    t = dataclasses.replace(tconfigs.smoke_config(tconfigs.get_config(ARCH)),
                            param_dtype=dtype)
    return j, t


@pytest.fixture(scope="module")
def model():
    jcfg, tcfg = _cfgs()
    jp = prm.materialize(model_defs(jcfg), jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    return jcfg, tcfg, jp, tp


def _jlayer(jp, i):
    """Layer i's JAX parameters: layer 0 is the dense segment, then MoE."""
    return jax.tree.map(lambda a: a[0], jp["blocks"][i]["s0"])


def test_params_from_numpy_dense_first_then_moe(model):
    jcfg, tcfg, jp, tp = model
    assert "mlp" in tp["layers"][0] and "moe" in tp["layers"][1]
    assert tp["layers"][0]["mlp"]["w_up"].shape[1] == tcfg.moe.dense_d_ff
    for i, layer in enumerate(tp["layers"]):
        for n, t in layer["attn"].items():
            np.testing.assert_array_equal(t.numpy(),
                                          np.asarray(_jlayer(jp, i)["attn"][n]))
    np.testing.assert_array_equal(
        tp["layers"][1]["moe"]["ws_down"].numpy(),
        np.asarray(_jlayer(jp, 1)["moe"]["ws_down"]))


def test_mla_latents_and_queries_match_jax(model):
    jcfg, tcfg, jp, tp = model
    x = np.random.default_rng(5).normal(size=(2, 7, tcfg.d_model)).astype(
        np.float32)
    pos = np.arange(3, 10, dtype=np.int32)
    p, jpl = tp["layers"][1]["attn"], _jlayer(jp, 1)["attn"]
    ctx = single_device_ctx()
    got = tattn.mla_latents(tcfg, p, torch.from_numpy(x), torch.from_numpy(pos))
    got += tattn.mla_queries(tcfg, p, torch.from_numpy(x),
                             torch.from_numpy(pos))
    want = jattn.mla_latents(jcfg, jpl, jnp.asarray(x), ctx, jnp.asarray(pos))
    want += jattn.mla_queries(jcfg, jpl, jnp.asarray(x), ctx,
                              jnp.asarray(pos))
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("bucket", [16, 32])
def test_prefill_logits_and_ckv_rows_match_jax(model, bucket):
    jcfg, tcfg, jp, tp = model
    rng = np.random.default_rng(bucket)
    lens = np.array([bucket // 2 + 1, bucket, 1], np.int32)
    toks = np.zeros((3, bucket), np.int32)
    for i, n in enumerate(lens):
        toks[i, :n] = rng.integers(0, tcfg.vocab, n)
    logits, cache = prefill(tcfg, tp, torch.from_numpy(toks),
                            prompt_len=torch.from_numpy(lens), page_size=8)
    jlogits, jcache = jprefill(jcfg, jp, jnp.asarray(toks),
                               single_device_ctx(),
                               prompt_len=jnp.asarray(lens), page_size=8)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               rtol=ATOL, atol=ATOL)
    R = tcfg.mla.kv_lora + tcfg.mla.rope_dim
    for i, layer in enumerate(cache["layers"]):
        assert set(layer) == {"ckv"}
        want = np.asarray(jcache["blocks"][i]["s0"]["ckv"][0])
        assert tuple(layer["ckv"].shape) == want.shape == (3, bucket, R)
        np.testing.assert_allclose(layer["ckv"].numpy(), want, rtol=ATOL,
                                   atol=ATOL)


def test_mla_pool_layout():
    _, tcfg = _cfgs()
    defs = paged_cache_defs(tcfg, num_pages=9, page_size=8, max_slots=1,
                            max_len=64)
    R = tcfg.mla.kv_lora + tcfg.mla.rope_dim
    assert [{n: s.shape for n, s in l.items()} for l in defs["layers"]] == \
        [{"ckv": (9, 8, R)}] * tcfg.n_layers


def test_paged_mla_decode_step_matches_jax(model):
    jcfg, tcfg, jp, tp = model
    rng = np.random.default_rng(6)
    B, T, ps = 3, 4, 8
    N = 1 + B * T
    R = tcfg.mla.kv_lora + tcfg.mla.rope_dim
    pools = [rng.normal(size=(N, ps, R)).astype(np.float32) * 0.5
             for _ in range(tcfg.n_layers)]
    pt = (1 + rng.permutation(N - 1).reshape(B, T)).astype(np.int32)
    pos = np.array([5, 2 * ps + 3, T * ps], np.int32)   # last: frozen slot
    tok = rng.integers(0, tcfg.vocab, B).astype(np.int32)
    tcache = {"layers": [{"ckv": torch.from_numpy(a.copy())} for a in pools]}
    jcache = {"blocks": [{"s0": {"ckv": jnp.asarray(a[None])}}
                         for a in pools]}
    got, tcache = tdec.decode_step(tcfg, tp, tcache, torch.from_numpy(tok),
                                   torch.from_numpy(pos), torch.from_numpy(pt))
    want, jcache = jdec.decode_step(jcfg, jp, jcache, jnp.asarray(tok),
                                    jnp.asarray(pos), single_device_ctx(),
                                    page_table=jnp.asarray(pt))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=ATOL,
                               atol=ATOL)
    for i, layer in enumerate(tcache["layers"]):
        np.testing.assert_allclose(
            layer["ckv"].numpy(), np.asarray(jcache["blocks"][i]["s0"]["ckv"][0]),
            rtol=ATOL, atol=ATOL)


def test_engine_greedy_streams_match_jax(model, monkeypatch):
    jcfg, tcfg, _, tp = model
    jreqs, reqs = serve_both(ARCH, jcfg, tcfg, tp, monkeypatch)
    assert [r.out for r in reqs] == [r.out for r in jreqs]
