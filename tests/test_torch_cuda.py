"""The port's hand-written CUDA kernels against their plain versions, on the
card. These skip where there is no CUDA device; on a machine with an H100:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import dataclasses
import time

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, smoke_config
from repro_torch.configs.gemm_paper import FPGA_CHUNK_SWEEP
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention import ref as flash_ref
from repro_torch.kernels.gemm import ops as gemm_ops
from repro_torch.kernels.gemm import ref as gemm_ref
from repro_torch.kernels.grouped_gemm import ops as gg_ops
from repro_torch.kernels.grouped_gemm import ref as gg_ref
from repro_torch.kernels.paged_attention import ops as paged_ops
from repro_torch.kernels.paged_attention import ref as paged_ref
from repro_torch.kernels.selective_scan import ops as scan_ops
from repro_torch.kernels.selective_scan import ref as scan_ref
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.kernels.ssd import ref as ssd_ref
from repro_torch.params import init_params, tree_leaves, tree_map
from repro_torch.serve.decode import combine_shards
from repro_torch.serve.engine import Engine, Request

pytestmark = pytest.mark.cuda

# f32 on the card: the kernel and the plain version sum in other orders and
# use their own expf; bf16 outputs round once more (3e-2 as tests/test_kernels)
TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _paged_case(dev, dtype, page_size, grp, dh, seed=0, hkv=2, B=3, T=4):
    rng = np.random.default_rng(seed)
    N = 1 + B * T

    def t(shape):
        return torch.tensor(rng.normal(size=shape), dtype=torch.float32,
                            device=dev).to(dtype)

    q = t((B, hkv, grp, dh))
    pk, pv = t((N, page_size, hkv, dh)), t((N, page_size, hkv, dh))
    pt = torch.tensor(1 + rng.permutation(N - 1)[:B * T].reshape(B, T),
                      dtype=torch.int32, device=dev)
    pos = torch.tensor([page_size - 1, 2 * page_size, T * page_size - 1][:B],
                       dtype=torch.int32, device=dev)
    return q, pk, pv, pt, pos


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("page_size", [8, 16])
@pytest.mark.parametrize("softcap", [0.0, 5.0])
@pytest.mark.parametrize("grp,dh", [(3, 16), (4, 128)])
def test_paged_kernel_matches_plain(dev, dtype, page_size, softcap, grp, dh):
    q, pk, pv, pt, pos = _paged_case(dev, dtype, page_size, grp, dh)
    for base in (0, page_size // 2):
        n0 = paged_ops.launches
        got = paged_ops.paged_attend_gqa(q, pk, pv, pt, pos, base,
                                         page_size=page_size, scale=0.25,
                                         softcap=softcap)
        assert paged_ops.launches == n0 + 1
        want = paged_ref.paged_flash_decode_gqa_ref(
            q, pk, pv, pt, pos, base, page_size=page_size, scale=0.25,
            softcap=softcap)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("shard", [0, 1])
def test_paged_kernel_shard_local_pool(dev, shard):
    """Pools holding one shard's half of every page (ps = page_size / 2,
    base = shard · ps): the kernel's keys skip the other shard's offsets."""
    q, pk, pv, pt, pos = _paged_case(dev, torch.float32, 16, 4, 128)
    half = slice(shard * 8, shard * 8 + 8)
    pk, pv = pk[:, half].contiguous(), pv[:, half].contiguous()
    got = paged_ops.paged_attend_gqa(q, pk, pv, pt, pos, shard * 8,
                                     page_size=16, scale=0.25)
    want = paged_ref.paged_flash_decode_gqa_ref(q, pk, pv, pt, pos,
                                                shard * 8, page_size=16,
                                                scale=0.25)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)


def test_paged_kernel_empty_row(dev):
    """A slot whose pos lies before the shard base has nothing live."""
    q, pk, pv, pt, pos = _paged_case(dev, torch.float32, 8, 4, 128)
    o, m, l = paged_ops.paged_attend_gqa(q, pk, pv, pt, pos * 0, 4,
                                         page_size=8, scale=0.25)
    assert torch.all(m == -1e30) and torch.all(l == 0) and torch.all(o == 0)


def test_paged_kernel_rejects_bad_inputs(dev):
    q, pk, pv, pt, pos = _paged_case(dev, torch.float32, 8, 4, 128)
    with pytest.raises(ValueError):
        paged_ops.paged_attend_gqa(q.to(torch.bfloat16), pk, pv, pt, pos,
                                   page_size=8, scale=0.25)
    with pytest.raises(ValueError):
        paged_ops.paged_attend_gqa(q, pk, pv, pt.long(), pos, page_size=8,
                                   scale=0.25)
    with pytest.raises(ValueError):
        paged_ops.paged_attend_gqa(q, pk, pv, pt[:, ::2], pos, page_size=8,
                                   scale=0.25)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal,window,softcap", [
    (True, 0, 0.0), (True, 64, 0.0), (False, 0, 0.0), (True, 0, 30.0),
    (True, 32, 50.0)])
@pytest.mark.parametrize("T,H,Hk,dh", [(128, 3, 3, 32), (100, 8, 2, 128),
                                       (37, 4, 1, 16), (50, 2, 2, 24),
                                       (300, 8, 2, 80), (100, 4, 2, 256)])
def test_flash_kernel_matches_plain(dev, dtype, causal, window, softcap, T,
                                    H, Hk, dh):
    g = torch.Generator(device=dev).manual_seed(0)

    def t(h, d):
        return torch.randn((2, h, T, d), generator=g, device=dev).to(dtype)

    q, k, v = t(H, dh), t(Hk, dh), t(Hk, dh)
    n0 = flash_ops.launches
    got = flash_ops.attend(q, k, v, scale=0.18, causal=causal, window=window,
                           softcap=softcap)
    assert flash_ops.launches == n0 + 1
    want = flash_ref.flash_attention_ref(q, k, v, scale=0.18, causal=causal,
                                         window=window, softcap=softcap)
    tol = TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


def test_flash_kernel_strided_views(dev):
    """Head-transposed views give the same values as contiguous inputs, and
    the output keeps q's memory order."""
    g = torch.Generator(device=dev).manual_seed(1)
    B, T, H, Hk, dh = 2, 70, 8, 2, 64
    q = torch.randn((B, T, H, dh), generator=g, device=dev)
    k = torch.randn((B, T, Hk, dh), generator=g, device=dev)
    v = torch.randn((B, T, Hk, dh), generator=g, device=dev)
    qv, kv, vv = (x.permute(0, 2, 1, 3) for x in (q, k, v))
    got = flash_ops.attend(qv, kv, vv, scale=0.125)
    assert got.permute(0, 2, 1, 3).is_contiguous()
    want = flash_ops.attend(qv.contiguous(), kv.contiguous(), vv.contiguous(),
                            scale=0.125)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_flash_kernel_rejects_bad_inputs(dev):
    q = torch.randn((1, 2, 16, 264), device=dev)
    with pytest.raises(ValueError):
        flash_ops.attend(q, q, q, scale=0.1)             # dh, dv > 256
    q = torch.randn((1, 3, 16, 32), device=dev)
    k = torch.randn((1, 2, 16, 32), device=dev)
    with pytest.raises(ValueError):
        flash_ops.attend(q, k, k, scale=0.1)             # 3 heads over 2


def test_bf16_prefill_decode_on_card_match_host(dev):
    """bf16 smoke model: prefill (tensor-core flash path) and one paged
    decode step on the card against the host's plain versions, at the
    repo's bf16 logits tolerance (3e-2 of the largest logit)."""
    from repro_torch.serve.decode import decode_step
    from repro_torch.serve.prefill import prefill
    cfg = smoke_config(get_config("mistral-nemo-12b"))
    params = init_params(cfg, seed=0, device="cpu")
    toks = torch.tensor(np.random.default_rng(0).integers(0, cfg.vocab,
                                                          (2, 32)),
                        dtype=torch.int32)
    pl = torch.tensor([20, 32], dtype=torch.int32)
    out = {}
    for device in ("cpu", dev):
        p = tree_map(lambda t: t.to(device), params)
        logits, cache = prefill(cfg, p, toks.to(device),
                                prompt_len=pl.to(device), page_size=8)
        pools = []
        for c in cache["layers"]:       # page 0 trash, 5 pages per slot
            pool = {}
            for n, r in c.items():
                pages = r.reshape((2, 4, 8) + tuple(r.shape[2:]))
                pool[n] = r.new_zeros((11, 8) + tuple(r.shape[2:]))
                pool[n][1:5], pool[n][6:10] = pages[0], pages[1]
            pools.append(pool)
        table = torch.arange(1, 11, dtype=torch.int32).reshape(2, 5)
        step, _ = decode_step(cfg, p, {"layers": pools},
                              toks[:, 0].to(device), pl.to(device),
                              table.to(device))
        out[str(device)] = (logits.cpu(), step.cpu())
    for a, b in zip(out["cpu"], out[str(dev)]):
        assert (a - b).abs().max() / a.abs().max() < 3e-2


@pytest.mark.parametrize("arch", ["mistral-nemo-12b", "deepseek-v2-236b",
                                  "phi3.5-moe-42b-a6.6b", "mamba2-130m",
                                  "nemotron-4-15b", "jamba-v0.1-52b"])
def test_engine_on_card_matches_host(dev, arch):
    """The paged engine on the card (every kernel of the model's path) gives
    the greedy streams of the same engine on the host (plain versions), in
    f32. Admission is pinned to one speed ratio, so both form the same
    prefill groups (MoE capacity couples a group's rows)."""
    cfg = dataclasses.replace(smoke_config(get_config(arch)),
                              param_dtype="float32")
    params = init_params(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab, n).tolist()
               for n in (4, 5, 9, 17, 18, 23, 63)]
    outs = []
    for device in ("cpu", dev):
        eng = Engine(cfg, tree_map(lambda t: t.to(device), params),
                     device=device, max_slots=3, max_len=64, page_size=8,
                     decode_quantum=4)
        eng.tracker.f = lambda: 0.01
        reqs = [Request(rid=i, prompt=p, max_new=6)
                for i, p in enumerate(prompts)]
        eng.run(reqs)
        eng.alloc.check()
        outs.append([r.out for r in reqs])
    assert outs[0] == outs[1]


def _graph_workload(cfg):
    """tests/test_torch_serve.py's prompts at page size 4 and max_len 128:
    the quanta take more than one page-table width."""
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab, n).tolist()
               for n in (4, 5, 9, 17, 18, 23, 63)]
    return prompts, dict(max_slots=3, max_len=128, page_size=4,
                         decode_quantum=4)


def _serve_counted(cfg, params, device, prompts, kw, max_new=6, **extra):
    """Serve ``prompts`` (``max_new`` tokens each) at a pinned admission
    ratio → (streams, engine, change of every wrapper's launch count)."""
    from repro_torch.serve import graphs
    eng = Engine(cfg, tree_map(lambda t: t.to(device), params),
                 device=device, **kw, **extra)
    eng.tracker.f = lambda: 0.01
    reqs = [Request(rid=i, prompt=p, max_new=max_new)
            for i, p in enumerate(prompts)]
    before = graphs.launch_counts()
    eng.run(reqs)
    torch.cuda.synchronize()
    if eng.paged:
        eng.alloc.check()
    delta = tuple(a - b for a, b in zip(graphs.launch_counts(), before))
    return [r.out for r in reqs], eng, delta


@pytest.mark.parametrize("arch", ["mistral-nemo-12b", "deepseek-v2-236b",
                                  "phi3.5-moe-42b-a6.6b", "mamba2-130m",
                                  "jamba-v0.1-52b"])
def test_engine_graphs_match_eager_and_host(dev, arch):
    """f32 smoke model: the engine's replayed CUDA graphs (one capture per
    live page-table width) give the streams of its eager loop on the card
    and of the host engine; the wrappers' launch counts of the graph run
    (captures' warm-ups plus every replay's recorded launches) equal the
    eager run's, which launches every kernel itself."""
    cfg = dataclasses.replace(smoke_config(get_config(arch)),
                              param_dtype="float32")
    params = init_params(cfg, seed=0, device="cpu")
    prompts, kw = _graph_workload(cfg)
    host, _, _ = _serve_counted(cfg, params, "cpu", prompts, kw)
    eager, e_eng, e_launch = _serve_counted(cfg, params, dev, prompts, kw,
                                            graphs=False)
    graph, g_eng, g_launch = _serve_counted(cfg, params, dev, prompts, kw)
    assert e_eng.graphs is None and g_eng.graphs is not None
    assert graph == eager == host
    assert g_eng.decode_captures == len(g_eng.widths_used)
    assert g_eng.widths_used == e_eng.widths_used
    assert g_eng.quanta > g_eng.decode_captures
    if "paged" in g_eng.kinds:
        assert len(g_eng.widths_used) > 1
    assert g_launch == e_launch and any(g_launch), (g_launch, e_launch)


LAYOUTS = [("gemma2-2b", True), ("gemma2-2b", False),
           ("h2o-danube-1.8b", False)]


@pytest.mark.parametrize("arch,paged", LAYOUTS,
                         ids=[f"{a}-{'paged' if p else 'dense'}"
                              for a, p in LAYOUTS])
def test_engine_graphs_rings_and_dense_match_eager_and_host(dev, arch,
                                                            paged):
    """f32 smoke models with sliding-window rings (window 32): gemma2's
    paged engine (global layers in the pool, local layers in rings, post-
    norm, softcaps) and the dense engine (gemma2, danube: one graph, no
    page table): replayed graphs = the eager loop on the card = the host
    engine, decoding past the window, and equal launch counts."""
    cfg = dataclasses.replace(smoke_config(get_config(arch)),
                              param_dtype="float32")
    params = init_params(cfg, seed=0, device="cpu")
    prompts, kw = _graph_workload(cfg)
    host, _, _ = _serve_counted(cfg, params, "cpu", prompts, kw,
                                paged=paged)
    eager, e_eng, e_launch = _serve_counted(cfg, params, dev, prompts, kw,
                                            graphs=False, paged=paged)
    graph, g_eng, g_launch = _serve_counted(cfg, params, dev, prompts, kw,
                                            paged=paged)
    assert graph == eager == host
    assert g_eng.decode_captures == len(g_eng.widths_used)
    assert g_eng.widths_used == e_eng.widths_used
    if not paged:
        assert set(g_eng.widths_used) == {0}
    assert g_eng.quanta > g_eng.decode_captures
    assert max(len(p) + len(o) for p, o in zip(prompts, graph)) > 33
    assert g_launch == e_launch and any(g_launch), (g_launch, e_launch)


def test_engine_graphs_sampled_match_eager(dev):
    """Sampled mistral smoke streams (temperature 0.8, top-k 50, one seed)
    from replayed graphs equal the eager loop's: the registered generator
    advances its Philox offset at each replay as the eager draws do."""
    cfg = dataclasses.replace(smoke_config(get_config("mistral-nemo-12b")),
                              param_dtype="float32")
    params = init_params(cfg, seed=0, device="cpu")
    prompts, kw = _graph_workload(cfg)
    sampled = dict(temperature=0.8, top_k=50, sample_seed=3)
    eager, _, _ = _serve_counted(cfg, params, dev, prompts, kw,
                                 graphs=False, **sampled)
    graph, eng, _ = _serve_counted(cfg, params, dev, prompts, kw, **sampled)
    greedy, _, _ = _serve_counted(cfg, params, dev, prompts, kw)
    assert eng.decode_captures > 1
    assert graph == eager != greedy


# ------------------------------------------------------------ grouped GEMM
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("E,M,K,N", [(4, 8, 128, 64), (3, 13, 64, 136),
                                     (5, 100, 96, 256), (2, 384, 1536, 40)])
def test_grouped_gemm_matches_plain(dev, dtype, E, M, K, N):
    """M = 8 (decode) and ragged M, N and K tile edges; both bf16 tile
    shapes (M <= 16 and above)."""
    g = torch.Generator(device=dev).manual_seed(E)
    a = torch.randn((E, M, K), generator=g, device=dev).to(dtype)
    w = torch.randn((E, K, N), generator=g, device=dev).to(dtype)
    n0 = gg_ops.launches
    got = gg_ops.grouped_gemm(a, w)
    assert gg_ops.launches == n0 + 1 and got.dtype == dtype
    want = gg_ref.grouped_gemm_ref(a, w)
    rel = float((got.float() - want.float()).abs().max() /
                want.float().abs().max())
    assert rel < (3e-2 if dtype == torch.bfloat16 else 1e-5), rel


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T", [1, 8, 24])
def test_grouped_gemm_stride0_operand(dev, dtype, T):
    """Decode's tokens broadcast over the experts (stride 0, no copy)."""
    g = torch.Generator(device=dev).manual_seed(T)
    x = torch.randn((T, 256), generator=g, device=dev).to(dtype)
    w = torch.randn((6, 256, 64), generator=g, device=dev).to(dtype)
    a = x.unsqueeze(0).expand(6, T, 256)
    got = gg_ops.grouped_gemm(a, w)
    want = gg_ops.grouped_gemm(a.contiguous(), w)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    ref = gg_ref.grouped_gemm_ref(a, w)
    assert float((got.float() - ref.float()).abs().max() /
                 ref.float().abs().max()) < 3e-2


def test_grouped_gemm_rejects_bad_inputs(dev):
    a = torch.randn((2, 8, 12), device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError):                 # K not a multiple of 8
        gg_ops.grouped_gemm(a, torch.randn((2, 12, 16), device=dev,
                                           dtype=torch.bfloat16))
    with pytest.raises(ValueError):                 # dtypes differ
        gg_ops.grouped_gemm(a.float(), torch.randn((2, 12, 16), device=dev,
                                                   dtype=torch.bfloat16))
    with pytest.raises(ValueError):                 # w not contiguous
        gg_ops.grouped_gemm(a[..., :8], torch.randn(
            (2, 16, 8), device=dev, dtype=torch.bfloat16).transpose(1, 2))


@pytest.mark.parametrize("M", [65, 130, 384])
@pytest.mark.parametrize("K", [136, 1536])
@pytest.mark.parametrize("N", [40, 1536])
def test_grouped_gemm_prefill_path(dev, M, K, N):
    """The wgmma prefill path at ragged M (tiles of 128), K (steps of 64)
    and N (tiles of 256): within 3e-2 of the largest value of the plain
    version, two calls bit-equal."""
    assert gg_ops.route(torch.bfloat16, M) == "prefill"
    g = torch.Generator(device=dev).manual_seed(M + K + N)
    a = torch.randn((3, M, K), generator=g, device=dev).to(torch.bfloat16)
    w = (torch.randn((3, K, N), generator=g, device=dev)
         * K ** -0.5).to(torch.bfloat16)
    got = gg_ops.grouped_gemm(a, w)
    assert torch.equal(got, gg_ops.grouped_gemm(a, w))
    assert _rel(got, gg_ref.grouped_gemm_ref(a, w)) < 3e-2


@pytest.mark.parametrize("M", [1, 13, 200])
def test_grouped_gemm_one_expert(dev, M):
    """E = 1 and, at M = 1, a row dim of extent 1 (dims of extent 1 in the
    tensor maps) on both bf16 paths."""
    g = torch.Generator(device=dev).manual_seed(M)
    a = torch.randn((1, M, 264), generator=g, device=dev).to(torch.bfloat16)
    w = (torch.randn((1, 264, 72), generator=g, device=dev)
         * 264 ** -0.5).to(torch.bfloat16)
    assert _rel(gg_ops.grouped_gemm(a, w), gg_ref.grouped_gemm_ref(a, w)) \
        < 3e-2


@pytest.mark.parametrize("M", [1, 8, 16])
@pytest.mark.parametrize("K,N", [(136, 40), (1536, 1536), (5120, 1536)])
def test_grouped_gemm_decode_path(dev, M, K, N):
    """The decode path with decode's stride-0 a (tokens broadcast over the
    experts): within 3e-2 of the plain version, two calls bit-equal, and
    equal to the same product on a contiguous a."""
    assert gg_ops.route(torch.bfloat16, M) == "decode"
    g = torch.Generator(device=dev).manual_seed(M + K)
    x = torch.randn((M, K), generator=g, device=dev).to(torch.bfloat16)
    w = (torch.randn((6, K, N), generator=g, device=dev)
         * K ** -0.5).to(torch.bfloat16)
    a = x.unsqueeze(0).expand(6, M, K)
    got = gg_ops.grouped_gemm(a, w)
    assert torch.equal(got, gg_ops.grouped_gemm(a, w))
    assert torch.equal(got, gg_ops.grouped_gemm(a.contiguous(), w))
    assert _rel(got, gg_ref.grouped_gemm_ref(a, w)) < 3e-2


# ------------------------------------------------------ paged MLA decode
def _mla_case(dev, dtype, page_size, H=12, R=72, B=4, T=260, seed=0):
    rng = np.random.default_rng(seed)
    N = 1 + B * T
    q = torch.tensor(rng.normal(size=(B, H, R)), dtype=torch.float32,
                     device=dev).to(dtype)
    pool = torch.tensor(rng.normal(size=(N, page_size, R)),
                        dtype=torch.float32, device=dev).to(dtype)
    pool[0] = 1e4                                  # trash page: never read
    pt = torch.tensor(1 + rng.permutation(N - 1).reshape(B, T),
                      dtype=torch.int32, device=dev)
    pos = torch.tensor([0, page_size - 1, page_size, 4095][:B],
                       dtype=torch.int32, device=dev)
    return q, pool, pt, pos


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("page_size", [8, 16])
@pytest.mark.parametrize("H,R,kv_lora", [(12, 72, 64), (16, 576, 512)])
def test_paged_mla_kernel_matches_plain(dev, dtype, page_size, H, R,
                                        kv_lora):
    """pos 0, ps - 1, ps and 4095; a head count that leaves a partial head
    group; the shard base as a second case."""
    q, pool, pt, pos = _mla_case(dev, dtype, page_size, H=H, R=R,
                                 T=4096 // page_size)
    for base in (0, page_size // 2):
        n0 = paged_ops.mla_launches
        got = paged_ops.paged_attend_mla(q, pool, pt, pos, base,
                                         page_size=page_size,
                                         kv_lora=kv_lora, scale=0.05)
        assert paged_ops.mla_launches == n0 + 1
        want = paged_ref.paged_flash_decode_mla_ref(
            q, pool, pt, pos, base, page_size=page_size, kv_lora=kv_lora,
            scale=0.05)
        o, m, l = got
        wo, wm, wl = want
        live = wl > 0
        assert torch.equal(live, l > 0)
        torch.testing.assert_close(m, wm, rtol=1e-4, atol=1e-4)
        torch.testing.assert_close(l, wl, rtol=1e-4, atol=1e-4)
        torch.testing.assert_close(o[live] / l[live][:, None],
                                   wo[live] / wl[live][:, None], rtol=1e-4,
                                   atol=1e-4)
        assert float(o.abs().max() / l.clamp(min=1).max()) < 1e3


@pytest.mark.parametrize("shard", [0, 1])
def test_paged_mla_kernel_shard_local_pool(dev, shard):
    q, pool, pt, pos = _mla_case(dev, torch.float32, 16, T=256)
    pool = pool[:, shard * 8:shard * 8 + 8].contiguous()
    got = paged_ops.paged_attend_mla(q, pool, pt, pos, shard * 8,
                                     page_size=16, kv_lora=64, scale=0.05)
    want = paged_ref.paged_flash_decode_mla_ref(q, pool, pt, pos, shard * 8,
                                                page_size=16, kv_lora=64,
                                                scale=0.05)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)


def test_paged_mla_kernel_empty_row_and_bad_inputs(dev):
    q, pool, pt, pos = _mla_case(dev, torch.float32, 8, T=512)
    o, m, l = paged_ops.paged_attend_mla(q, pool, pt, pos * 0, 4,
                                         page_size=8, kv_lora=64, scale=0.1)
    assert torch.all(m == -1e30) and torch.all(l == 0) and torch.all(o == 0)
    with pytest.raises(ValueError):                 # R not a multiple of 8
        paged_ops.paged_attend_mla(q[..., :70].contiguous(),
                                   pool[..., :70].contiguous(), pt, pos,
                                   page_size=8, kv_lora=64, scale=0.1)
    with pytest.raises(ValueError):                 # kv_lora above R
        paged_ops.paged_attend_mla(q, pool, pt, pos, page_size=8,
                                   kv_lora=80, scale=0.1)


# ------------------------------------ paged decode on the tensor cores
# The main path's slots: a 4096-key slot over all 16 splits, an empty slot
# (pos before the first position), keys ending exactly on a split edge (256,
# 512 and 1024 keys: MLA's and GQA's chunks) and one key past one, one
# page, and a long ragged slot
MAIN_POS = [4095, -1, 255, 256, 15, 511, 2897, 1023]


def _main_tables(dev, B=8, T=256, seed=0):
    rng = np.random.default_rng(seed)
    N = 1 + B * T
    pt = torch.tensor(1 + rng.permutation(N - 1).reshape(B, T),
                      dtype=torch.int32, device=dev)
    pos = torch.tensor(MAIN_POS[:B], dtype=torch.int32, device=dev)
    return N, pt, pos


def _poison(pools, pt, pos, ps=16):
    """NaN in the trash page and in every slot's rows past pos within its
    last page (past pos for base 0 and ps / 2 alike): rows no result may
    read."""
    for pool in pools:
        pool[0] = float("nan")
        for b, p in enumerate(pos.tolist()):
            if p >= 0:
                pool[int(pt[b, p // ps]), p % ps + 1:] = float("nan")


def _gqa_main(dev, grp=4, dh=128, hkv=8, B=8, seed=0):
    N, pt, pos = _main_tables(dev, B, seed=seed)
    g = torch.Generator(device=dev).manual_seed(seed)
    bf = torch.bfloat16
    q = torch.randn((B, hkv, grp, dh), generator=g, device=dev).to(bf)
    pk, pv = (torch.randn((N, 16, hkv, dh), generator=g, device=dev).to(bf)
              for _ in range(2))
    _poison((pk, pv), pt, pos)
    return q, pk, pv, pt, pos


def _mla_main(dev, H=128, R=576, B=8, seed=0):
    N, pt, pos = _main_tables(dev, B, seed=seed)
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((B, H, R), generator=g, device=dev).to(torch.bfloat16)
    pool = torch.randn((N, 16, R), generator=g, device=dev).to(
        torch.bfloat16)
    _poison((pool,), pt, pos)
    return q, pool, pt, pos


def _close_partials(got, want):
    """The partials within the f32 checks: m, l and o to 1e-4, the same
    rows live, and o/l to 1e-4 on live rows."""
    o, m, l = got
    wo, wm, wl = want
    live = wl > 0
    assert torch.equal(live, l > 0)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(o[live] / l[live][..., None],
                               wo[live] / wl[live][..., None], rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("softcap", [0.0, 30.0])
@pytest.mark.parametrize("base", [0, 8])
@pytest.mark.parametrize("grp,dh", [(4, 128), (6, 128), (8, 64), (1, 128),
                                    (2, 256)])
def test_paged_gqa_mma_main_shape(dev, softcap, base, grp, dh):
    """The tensor-core route at the main path's table (256 pages of 16, 8
    splits) against the plain version: 4095 keys across every split, an
    empty slot, keys ending on a split edge, base 0 and ps / 2, softcap 0
    and 30; NaN in the trash page and past pos in each slot's last page
    never reaches a result."""
    q, pk, pv, pt, pos = _gqa_main(dev, grp, dh)
    assert paged_ops.gqa_route(q.dtype, grp, dh) == "mma"
    assert paged_ops.split_plan(pt.shape[1], 16, paged_ops.GQA_PLAN) == \
        (8, 512)
    kw = dict(page_size=16, scale=dh ** -0.5, softcap=softcap)
    got = paged_ops.paged_attend_gqa(q, pk, pv, pt, pos, base, **kw)
    want = paged_ref.paged_flash_decode_gqa_ref(
        q, pk.nan_to_num(), pv.nan_to_num(), pt, pos, base, **kw)
    _close_partials(got, want)
    o, m, l = got
    assert torch.all(m[1] == -1e30) and torch.all(l[1] == 0) and \
        torch.all(o[1] == 0)


@pytest.mark.parametrize("m", [2, 4])
def test_paged_gqa_shards_in_turn(dev, m):
    """The kv_seq-sharded decode at the main shape, one card: the pools
    cut into m slices of 16/m in-page offsets (ps_loc 8 and 4; at 4 one
    16-key tile spans four pages), each slice's partials at base i·16/m,
    page_size 16, against the plain version's, and the merge
    (``decode.combine_shards`` over the stacked slices) against the
    unsharded kernel."""
    q, pk, pv, pt, pos = _gqa_main(dev)
    N, ps, hkv, dh = pk.shape
    psl = ps // m
    kw = dict(page_size=ps, scale=dh ** -0.5)
    parts = []
    for i in range(m):
        sk, sv = (p.view(N, m, psl, hkv, dh)[:, i].contiguous()
                  for p in (pk, pv))
        got = paged_ops.paged_attend_gqa(q, sk, sv, pt, pos, i * psl, **kw)
        _close_partials(got, paged_ref.paged_flash_decode_gqa_ref(
            q, sk.nan_to_num(), sv.nan_to_num(), pt, pos, i * psl, **kw))
        parts.append(got)
    merged = combine_shards(*(torch.stack(x) for x in zip(*parts)),
                            lambda t: t.amax(0),
                            lambda a, b: (a.sum(0), b.sum(0)))
    o, _, l = paged_ops.paged_attend_gqa(q, pk, pv, pt, pos, 0, **kw)
    torch.testing.assert_close(merged, o / l.clamp_min(1e-30)[..., None],
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("base", [0, 8])
@pytest.mark.parametrize("H,R", [(128, 576), (16, 576), (96, 576),
                                 (64, 512)])
def test_paged_mla_wgmma_main_shape(dev, base, H, R):
    """The wgmma route at the main path's table against the plain version:
    deepseek-v2's 128 heads and head counts that leave part of a 64-head
    block (16, 96), R 576 and 512; the same slots and NaN rows as for
    GQA."""
    q, pool, pt, pos = _mla_main(dev, H, R)
    assert paged_ops.mla_route(q.dtype, H, R, 512, 16) == "wgmma"
    kw = dict(page_size=16, kv_lora=512, scale=192 ** -0.5)
    got = paged_ops.paged_attend_mla(q, pool, pt, pos, base, **kw)
    want = paged_ref.paged_flash_decode_mla_ref(q, pool.nan_to_num(), pt,
                                                pos, base, **kw)
    _close_partials(got, want)
    o, m, l = got
    assert torch.all(m[1] == -1e30) and torch.all(l[1] == 0) and \
        torch.all(o[1] == 0)


def _paged_calls(dev):
    q, pk, pv, pt, pos = _gqa_main(dev)
    q2, pk2, pv2, pt2, pos2 = _gqa_main(dev, grp=2, dh=256, hkv=4)
    qm, pool, ptm, posm = _mla_main(dev)
    gqa = (lambda p: paged_ops.paged_attend_gqa(
        q, pk, pv, pt, p, 0, page_size=16, scale=0.088, softcap=30.0))
    gqa256 = (lambda p: paged_ops.paged_attend_gqa(
        q2, pk2, pv2, pt2, p, 0, page_size=16, scale=0.0625, softcap=50.0))
    mla = (lambda p: paged_ops.paged_attend_mla(
        qm, pool, ptm, p, 0, page_size=16, kv_lora=512, scale=0.072))
    return {"gqa": (gqa, pos, "launches"), "gqa256": (gqa256, pos2,
                                                      "launches"),
            "mla": (mla, posm, "mla_launches")}


@pytest.mark.parametrize("op", ["gqa", "gqa256", "mla"])
def test_paged_tensor_core_one_launch_bit_equal(dev, op):
    """One call: the launch count +1 and one kernel on the card (the merge
    runs in the same launch); two calls bit-equal (the partials merge in
    split order whichever block arrives last)."""
    from torch.profiler import ProfilerActivity, profile
    fn, pos, counter = _paged_calls(dev)[op]
    first = fn(pos)                              # counters made before
    torch.cuda.synchronize()
    n0 = getattr(paged_ops, counter)
    # idle at both ends: the profiler drops a kernel whose device
    # timestamps fall just outside its window (chip_smoke.PROFILE_PAD_S)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(0.02)
        again = fn(pos)
        torch.cuda.synchronize()
        time.sleep(0.02)
    assert getattr(paged_ops, counter) == n0 + 1
    kernels = [e.name for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    want = "paged_mla_wgmma" if op == "mla" else "paged_gqa_mma"
    assert len(kernels) == 1 and want in kernels[0], kernels
    assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.parametrize("op", ["gqa", "gqa256", "mla"])
def test_paged_tensor_core_cuda_graph(dev, op):
    """One call captured in a CUDA graph and replayed twice, with other
    positions written into pos before the second replay: each replay equals
    an eager call (the arrival counters are back at 0 after every
    launch)."""
    fn, pos, _ = _paged_calls(dev)[op]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):               # counters of this stream
        fn(pos)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        out = fn(pos)
    graph.replay()
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(out, fn(pos)))
    pos.copy_(torch.tensor([100, 4095, 3000, -1, 511, 512, 16, 2048],
                           dtype=torch.int32, device=dev))
    graph.replay()
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(out, fn(pos)))


def test_paged_kernels_run_tensor_cores_and_async_copies(dev):
    """The SASS of every tensor-core paged kernel holds tensor-core products
    and asynchronous copies: mma.sync (HMMA) and cp.async (LDGSTS) for GQA,
    wgmma (HGMMA) and TMA tile loads (UTMALDG) for MLA."""
    _build.build(("paged_attention",))
    counts = _build.sass_counts("paged_attention")
    for dh in (64, 128, 256):
        for cap in (0, 1):
            c = counts[f"paged_gqa_mma<{dh}, {cap}>"]
            assert c["HMMA"] > 0 and c["LDGSTS"] > 0, c
    for R in (512, 576):
        c = counts[f"paged_mla_wgmma<{R}>"]
        assert c["HGMMA"] > 0 and c["UTMALDG"] > 0, c


# ------------------------------------------------ flash, MLA head dims
@pytest.mark.parametrize("T", [1024, 333])
def test_flash_kernel_mla_dims_match_plain(dev, T):
    """q/k dim 192 (nope 128 + rope 64), v dim 128, 16 heads, G = 1, in the
    prefill's layout: q and k contiguous (B, T, H, 192), v a strided slice
    of the up-projected (B, T, H, 256)."""
    g = torch.Generator(device=dev).manual_seed(T)
    B, H = 2, 16
    q = torch.randn((B, T, H, 192), generator=g, device=dev).to(torch.bfloat16)
    k = torch.randn((B, T, H, 192), generator=g, device=dev).to(torch.bfloat16)
    kv = torch.randn((B, T, H, 256), generator=g, device=dev).to(
        torch.bfloat16)
    qv, kvv, vv = (x.permute(0, 2, 1, 3) for x in (q, k, kv[..., 128:]))
    got = flash_ops.attend(qv, kvv, vv, scale=192 ** -0.5, causal=True)
    want = flash_ref.flash_attention_ref(qv, kvv, vv, scale=192 ** -0.5,
                                         causal=True)
    assert got.shape == (B, H, T, 128)
    torch.testing.assert_close(got.float(), want.float(), rtol=3e-2,
                               atol=3e-2)


# --------------------------------- flash forward on wgmma and TMA (bf16)
def _fwd_views(dev, B, T, H, Hk, dh, dv, seed, mla=False):
    """q, k, v in the layout prefill and training pass them: head-transposed
    views of (B, T, heads, d) memory; MLA's v is the tail of the
    up-projected (nope + v) rows, 256 bytes into each."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def t(h, d):
        return torch.randn((B, T, h, d), generator=g, device=dev).to(
            torch.bfloat16)

    q, k = t(H, dh), t(Hk, dh)
    v = t(Hk, 128 + dv)[..., 128:] if mla else t(Hk, dv)
    return tuple(x.permute(0, 2, 1, 3) for x in (q, k, v))


@pytest.mark.parametrize("T", [129, 640, 1000, 2048])
@pytest.mark.parametrize("H,Hk,dh,dv,mla", [(8, 2, 64, 64, False),
                                            (8, 2, 128, 128, False),
                                            (12, 2, 128, 128, False),
                                            (4, 4, 192, 128, True),
                                            (8, 4, 256, 256, False)])
@pytest.mark.parametrize("causal,window,softcap", [
    (True, 0, 0.0), (True, 256, 0.0), (True, 0, 30.0), (False, 0, 0.0),
    (True, 256, 30.0)])
def test_flash_wgmma_matches_plain(dev, T, H, Hk, dh, dv, mla, causal,
                                   window, softcap):
    """The wgmma path: out within 3e-2 and lse within 1e-4 of the plain
    versions, windows across 128-key tile edges, ragged T, two calls
    bit-equal and the lse launch's o equal to the serving launch's."""
    assert flash_ops.fwd_route(torch.bfloat16, dh, dv, True) == "wgmma"
    q, k, v = _fwd_views(dev, 2, T, H, Hk, dh, dv, seed=T + dh, mla=mla)
    kw = dict(scale=dh ** -0.5, causal=causal, window=window,
              softcap=softcap)
    n0 = flash_ops.launches
    got = flash_ops.attend(q, k, v, **kw)
    assert flash_ops.launches == n0 + 1
    assert got.permute(0, 2, 1, 3).is_contiguous()
    assert torch.equal(got, flash_ops.attend(q, k, v, **kw))
    want = flash_ref.flash_attention_ref(q, k, v, **kw)
    torch.testing.assert_close(got.float(), want.float(), rtol=3e-2,
                               atol=3e-2)
    o, lse = flash_ops.attend_fwd_lse(q, k, v, **kw)
    assert torch.equal(o, got)
    _, lse_r = flash_ref.flash_attention_fwd_lse_ref(q, k, v, **kw)
    torch.testing.assert_close(lse, lse_r, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("layout", ["contiguous", "head-transposed"])
def test_flash_wgmma_single_batch_and_kv_head(dev, layout):
    """B = 1 and one kv head (dims of extent 1 in the tensor maps), Tq
    shorter than Tk, causal: against the plain version."""
    g = torch.Generator(device=dev).manual_seed(5)
    dt = torch.bfloat16
    if layout == "contiguous":
        q = torch.randn((1, 4, 300, 128), generator=g, device=dev).to(dt)
        k, v = (torch.randn((1, 1, 420, 128), generator=g, device=dev).to(dt)
                for _ in range(2))
    else:
        q = torch.randn((1, 300, 4, 128), generator=g, device=dev).to(dt)
        k, v = (torch.randn((1, 420, 1, 128), generator=g, device=dev).to(dt)
                for _ in range(2))
        q, k, v = (x.permute(0, 2, 1, 3) for x in (q, k, v))
    got = flash_ops.attend(q, k, v, scale=0.09, causal=True)
    want = flash_ref.flash_attention_ref(q, k, v, scale=0.09, causal=True)
    torch.testing.assert_close(got.float(), want.float(), rtol=3e-2,
                               atol=3e-2)


def test_redesigned_kernels_run_wgmma_and_tma(dev):
    """The SASS of the wgmma flash forward (every instance) and of both
    bf16 grouped-GEMM paths holds warpgroup products (HGMMA) and TMA tile
    loads (UTMALDG)."""
    _build.build(("flash_attention", "grouped_gemm"))
    fa = _build.sass_counts("flash_attention")
    gg = _build.sass_counts("grouped_gemm")
    for counts in [fa[f"flash_fwd_wgmma<{dh}, {dv}>"]
                   for dh, dv in ((64, 64), (128, 128), (192, 128),
                                  (256, 256))] + \
            [gg["gg_prefill"], gg["gg_decode"]]:
        assert counts["HGMMA"] > 0 and counts["UTMALDG"] > 0, (fa, gg)


# ------------------------------------------------------------ tiled GEMM
def _rel(got, want):
    return float((got.float() - want.float()).abs().max() /
                 want.float().abs().max())


# f32 on CUDA cores sums in another order than cuBLAS; bf16 outputs round
# once (tests/test_kernels.py::test_gemm_sweep holds bf16 to 2e-2)
GEMM_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,K,N", [(256, 512, 384), (97, 136, 200),
                                   (1, 64, 64), (300, 1024, 256)])
def test_gemm_kernel_matches_plain(dev, dtype, M, K, N):
    """Ragged M, N and K tile edges at the default block shape."""
    g = torch.Generator(device=dev).manual_seed(M)
    a = torch.randn((M, K), generator=g, device=dev).to(dtype)
    b = torch.randn((K, N), generator=g, device=dev).to(dtype)
    n0 = gemm_ops.launches
    got = gemm_ops.gemm(a, b)
    assert gemm_ops.launches == n0 + 1 and got.dtype == dtype
    assert _rel(got, gemm_ref.gemm_ref(a, b)) < GEMM_TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("block", sorted(gemm_ops.SHAPES))
def test_gemm_kernel_every_block_shape(dev, dtype, block):
    """Every compiled (bm, bn, bk) — the bn sweep of Table 2 included —
    on a row chunk A[b:e] of a larger A (a view, not a copy), with its
    launch's shared memory equal to the law."""
    bm, bn, bk = block
    g = torch.Generator(device=dev).manual_seed(bn + bk)
    A = torch.randn((300, 256), generator=g, device=dev).to(dtype)
    b = torch.randn((256, 264), generator=g, device=dev).to(dtype)
    a = A[40:237]
    got = gemm_ops.gemm(a, b, bm=bm, bn=bn, bk=bk)
    assert _rel(got, gemm_ref.gemm_ref(a, b)) < GEMM_TOL[dtype]
    lib = gemm_ops._lib()
    size = a.element_size()
    assert lib.gemm_smem_bytes(int(dtype == torch.bfloat16), bm, bn, bk) == \
        gemm_ops.smem_bytes(bm, bn, bk, size)


def test_gemm_kernel_rejects_bad_inputs(dev):
    a = torch.randn((64, 64), device=dev)
    with pytest.raises(ValueError, match="shared memory"):
        gemm_ops.gemm(a, a, bm=256, bn=256, bk=512)   # the JAX defaults
    with pytest.raises(ValueError, match="not compiled"):
        gemm_ops.gemm(a, a, bm=32, bn=32, bk=32)
    h = a.to(torch.bfloat16)
    with pytest.raises(ValueError):                    # N not a multiple of 8
        gemm_ops.gemm(h, torch.randn((64, 12), device=dev,
                                     dtype=torch.bfloat16))
    with pytest.raises(ValueError):                    # b not contiguous
        gemm_ops.gemm(a, a.t())


@pytest.mark.parametrize("sf", FPGA_CHUNK_SWEEP)
def test_gemm_plan_on_hbb_chunks(dev, sf):
    """The hbb path's chunks A[:S_f] of a 1024² f32 A at their plan: within
    1e-5 of the plain product, one launch per call, and two calls bit-equal
    (the split partials are summed in split order, no atomics)."""
    g = torch.Generator(device=dev).manual_seed(0)
    A = torch.randn((1024, 1024), generator=g, device=dev)
    b = torch.randn((1024, 1024), generator=g, device=dev)
    a = A[:sf]
    bm, bn, bk, splits = gemm_ops.plan(sf, 1024, 1024, torch.float32)
    assert splits > 1
    n0 = gemm_ops.launches
    got = gemm_ops.gemm(a, b)
    assert gemm_ops.launches == n0 + 1
    assert _rel(got, gemm_ref.gemm_ref(a, b)) < GEMM_TOL[torch.float32]
    assert torch.equal(got, gemm_ops.gemm(a, b))


@pytest.mark.parametrize("M,K,N", [(97, 1000, 200), (1, 4096, 72),
                                   (300, 1030, 257), (40, 777, 1024)])
def test_gemm_plan_ragged(dev, M, K, N):
    """Ragged M, N and K at their plan (split K with a short last slice,
    the 4-byte copy path where K or N is not a multiple of 4): within 1e-5
    of the plain product and bit-equal across calls."""
    g = torch.Generator(device=dev).manual_seed(K)
    a = torch.randn((M + 3, K), generator=g, device=dev)[3:]
    b = torch.randn((K, N), generator=g, device=dev)
    got = gemm_ops.gemm(a, b)
    assert _rel(got, gemm_ref.gemm_ref(a, b)) < GEMM_TOL[torch.float32]
    assert torch.equal(got, gemm_ops.gemm(a, b))
    assert gemm_ops.plan(M, N, K, torch.float32)[3] > 1


@pytest.mark.parametrize("split", [0, 97, 256])
def test_matmul_row_split_on_card(dev, split):
    """Rows [0, split) through the kernel on the card, the rest on the
    host: the result lies on the card, equals the plain product, and the
    kernel launched exactly when the accelerator had rows."""
    g = torch.Generator(device=dev).manual_seed(split)
    a = torch.randn((256, 128), generator=g, device=dev)
    b = torch.randn((128, 192), generator=g, device=dev)
    n0 = gemm_ops.launches
    got = gemm_ops.matmul_row_split(a, b, split)
    assert got.device == a.device and got.shape == (256, 192)
    assert gemm_ops.launches == n0 + (1 if split else 0)
    assert _rel(got, gemm_ref.gemm_ref(a, b)) < GEMM_TOL[torch.float32]


def test_hetero_gemm_driver_on_card(dev):
    """The paper's experiment at a small size on the card: every config's
    C equals the plain product, and the accelerator tier launched the
    kernel."""
    from repro_torch.examples import hetero_gemm
    n0 = gemm_ops.launches
    rows = hetero_gemm.fig5(256, 2, (16, 64), device=dev,
                            printer=lambda s: None)
    assert all(r.ok for r in rows)
    assert gemm_ops.launches > n0


# --------------------------------------------------------- SSD intra-chunk
def _ssd_case(dev, G, H, Q, P, N, seed=0, steep=False):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((G, Q, H, P), generator=g, device=dev)
    if steep:      # exp(cs[t] - cs[s]) overflows above the diagonal
        cs = -100.0 * torch.arange(Q, device=dev, dtype=torch.float32)
        cs = cs[None, :, None].expand(G, Q, H).contiguous()
    else:
        cs = torch.cumsum(-torch.nn.functional.softplus(torch.randn(
            (G, Q, H), generator=g, device=dev)), dim=1)
    B = torch.randn((G, Q, N), generator=g, device=dev)
    C = torch.randn((G, Q, N), generator=g, device=dev)
    # ssd_scan's views: heads second, B and C with stride 0 over heads
    return (x.permute(0, 2, 1, 3), cs.permute(0, 2, 1),
            B[:, None].expand(-1, H, -1, -1), C[:, None].expand(-1, H, -1, -1))


@pytest.mark.parametrize("Q", [32, 97, 256])
@pytest.mark.parametrize("G,H,P,N,route", [
    (4, 3, 16, 32, "mma"), (4, 2, 64, 128, "mma"), (4, 1, 72, 40, "f32"),
    (4, 3, 20, 36, "f32"), (8, 24, 64, 128, "mma")])
def test_ssd_kernel_matches_plain(dev, Q, G, H, P, N, route):
    """Q of a full chunk, an exact-length ragged chunk and 32; P and N that
    fill, split and leave ragged tiles (P 72 and P 20 on the CUDA-core route,
    the rest on the tensor cores, among them mamba2-130m's 8 chunk rows x 24
    heads); stride-0 B and C. Each call runs the route ssd_route gives it."""
    x, cs, B, C = _ssd_case(dev, G, H, Q, P, N, seed=Q + P)
    assert ssd_ops.route_of(x, B, C) == route
    n0, r0 = ssd_ops.launches, ssd_ops.route_launches[route]
    y, st = ssd_ops.intra_chunk(x, cs, B, C)
    assert ssd_ops.launches == n0 + 1
    assert ssd_ops.route_launches[route] == r0 + 1
    assert y.shape == (G, H, Q, P) and st.shape == (G, H, N, P)
    yr, str_ = ssd_ref.ssd_intra_chunk_ref(x, cs, B, C)
    assert _rel(y, yr) < TOL[torch.float32]
    assert _rel(st, str_) < TOL[torch.float32]


@pytest.mark.parametrize("Q", [97, 256])
def test_ssd_kernel_own_bc_per_head(dev, Q):
    """The TPU contract's flat G: B and C of their own for every head
    (nonzero head strides), on the tensor cores with one head a group."""
    G, H, P, N = 3, 4, 64, 128
    x, cs, _, _ = _ssd_case(dev, G, H, Q, P, N, seed=Q)
    g = torch.Generator(device=dev).manual_seed(Q + 1)
    B = torch.randn((G, H, Q, N), generator=g, device=dev)
    C = torch.randn((G, H, Q, N), generator=g, device=dev)
    assert ssd_ops.route_of(x, B, C) == "mma"
    assert ssd_ops.plan_of(x, B, C)[:2] == (1, 1)
    y, st = ssd_ops.intra_chunk(x, cs, B, C)
    yr, str_ = ssd_ref.ssd_intra_chunk_ref(x, cs, B, C)
    assert _rel(y, yr) < TOL[torch.float32]
    assert _rel(st, str_) < TOL[torch.float32]


@pytest.mark.parametrize("P,N,route", [(64, 128, "mma"), (72, 40, "f32")])
def test_ssd_kernel_bit_equal_calls(dev, P, N, route):
    """Every output element is summed by one block in a fixed order: two
    calls give the same bits on both routes."""
    x, cs, B, C = _ssd_case(dev, 8, 24, 256, P, N, seed=P)
    assert ssd_ops.route_of(x, B, C) == route
    y1, st1 = ssd_ops.intra_chunk(x, cs, B, C)
    y2, st2 = ssd_ops.intra_chunk(x, cs, B, C)
    assert torch.equal(y1, y2) and torch.equal(st1, st2)


def test_ssd_kernel_runs_tensor_cores_and_async_copies(dev):
    """The SASS of ssd_mma holds tensor-core products (HMMA) and
    asynchronous copies (LDGSTS), and ptxas spilled nothing."""
    _build.build(("ssd",))
    c = _build.sass_counts("ssd")["ssd_mma"]
    assert c["HMMA"] > 0 and c["LDGSTS"] > 0, c
    r = _build.ptxas_stats("ssd")["ssd_mma"]
    assert r["spill_stores"] == 0 and r["spill_loads"] == 0, r


@pytest.mark.parametrize("P,N,route", [(16, 32, "mma"), (72, 40, "f32")])
def test_ssd_kernel_overflow_above_diagonal(dev, P, N, route):
    """A steep cs overflows exp above the diagonal: each route's kernel
    selects, so y stays finite and equal to the plain version."""
    x, cs, B, C = _ssd_case(dev, 2, 2, 64, P, N, steep=True)
    assert ssd_ops.route_of(x, B, C) == route
    y, st = ssd_ops.intra_chunk(x, cs, B, C)
    assert torch.isfinite(y).all() and torch.isfinite(st).all()
    yr, str_ = ssd_ref.ssd_intra_chunk_ref(x, cs, B, C)
    assert _rel(y, yr) < TOL[torch.float32]
    assert _rel(st, str_) < TOL[torch.float32]


def test_ssd_kernel_refuses_head_groups_of_own_bc(dev, monkeypatch):
    """ssd_mma shares a group's B and C across its heads, so its entry
    refuses a plan of head groups (hpb or hs above 1) when B or C has a
    head stride of its own, rather than use one head's B and C for all."""
    G, H, Q, P, N = 2, 4, 64, 64, 128
    x, cs, _, _ = _ssd_case(dev, G, H, Q, P, N)
    g = torch.Generator(device=dev).manual_seed(1)
    B = torch.randn((G, H, Q, N), generator=g, device=dev)
    C = torch.randn((G, H, Q, N), generator=g, device=dev)
    for hpb, hs in ((4, 1), (1, 2)):
        plan = ssd_ops.SsdPlan(hpb, hs, 0, 0)
        monkeypatch.setattr(ssd_ops, "plan_of", lambda *a, p=plan: p)
        n0 = ssd_ops.launches
        with pytest.raises(RuntimeError, match="ssd_intra_chunk"):
            ssd_ops.intra_chunk(x, cs, B, C)
        assert ssd_ops.launches == n0


def test_ssd_kernel_rejects_bad_inputs(dev):
    x, cs, B, C = _ssd_case(dev, 2, 2, 32, 16, 32)
    with pytest.raises(ValueError):
        ssd_ops.intra_chunk(x.to(torch.bfloat16), cs, B, C)
    with pytest.raises(ValueError):
        ssd_ops.intra_chunk(x, cs[..., :16], B, C)
    with pytest.raises(ValueError):
        ssd_ops.intra_chunk(x.transpose(2, 3), cs, B, C)


def test_ssd_scan_on_card_matches_host(dev):
    """The chunked scan through the kernel on the card against the same
    scan through the plain version on the host (f32)."""
    from repro_torch.models.mamba import ssd_scan
    g = torch.Generator().manual_seed(0)
    xh = torch.randn((2, 300, 3, 16), generator=g)
    dta = -torch.nn.functional.softplus(torch.randn((2, 300, 3), generator=g))
    Bm, Cm = torch.randn((2, 2, 300, 32), generator=g)
    y, h = ssd_scan(xh, dta, Bm, Cm, chunk=128)
    n0 = ssd_ops.launches
    yd, hd = ssd_scan(*(t.to(dev) for t in (xh, dta, Bm, Cm)), chunk=128)
    assert ssd_ops.launches == n0 + 1
    assert _rel(yd.cpu(), y) < TOL[torch.float32]
    assert _rel(hd.cpu(), h) < TOL[torch.float32]


# ------------------------------------------------ Mamba-1 selective scan
def _scan_case(dev, B, S, C, N, seed=0):
    """x, dt, A, Bm, Cm and a nonzero h0 on the card, f32, as the Mamba-1
    mixer passes them (dt > 0 from a softplus, A = -exp(·) < 0)."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def t(*shape):
        return torch.randn(shape, generator=g, device=dev)

    dt = torch.nn.functional.softplus(t(B, S, C) - 1.0)
    A = -torch.exp(0.5 * t(C, N))
    return t(B, S, C), dt, A, t(B, S, N), t(B, S, N), t(B, C, N)


@pytest.mark.parametrize("B,S,C,N", [(1, 37, 40, 16), (2, 100, 256, 8),
                                     (3, 65, 70, 24), (8, 300, 128, 64),
                                     (1, 1, 33, 16), (2, 2000, 512, 16),
                                     (1, 7, 32, 16), (2, 17, 96, 32),
                                     (8, 53, 100, 16), (1, 16, 64, 40),
                                     (3, 48, 36, 48), (1, 33, 4, 56)])
def test_selective_scan_kernel_matches_plain(dev, B, S, C, N):
    """S of one step, below one 16-step tile, just past one and several
    off the boundary; C off the forward's 32-channel blocks and not a
    multiple of 4 (4-byte copies); N from 8 to 64 (2 to 16 state entries a
    lane); B up to 8; a nonzero h0; one launch a call."""
    ins = _scan_case(dev, B, S, C, N, seed=S + N)
    n0 = scan_ops.launches
    y, h = scan_ops.selective_scan(*ins, 256)
    assert scan_ops.launches == n0 + 1
    assert y.shape == (B, S, C) and h.shape == (B, C, N)
    yr, hr = scan_ref.selective_scan_ref(*ins, 256)
    assert _rel(y, yr) < TOL[torch.float32]
    assert _rel(h, hr) < TOL[torch.float32]


def test_selective_scan_kernel_bit_equal_calls(dev):
    """Each channel's steps run in order in one block: two calls give the
    same bits."""
    ins = _scan_case(dev, 2, 300, 256, 16)
    y1, h1 = scan_ops.selective_scan(*ins, 256)
    y2, h2 = scan_ops.selective_scan(*ins, 256)
    assert torch.equal(y1, y2) and torch.equal(h1, h2)


def test_selective_scan_unaligned_operands(dev):
    """Operands whose data is not 16-byte aligned (a contiguous view one
    float into its storage) give what aligned copies of them give, forward
    and backward."""
    B, S, C, N = 2, 40, 64, 16
    ins = _scan_case(dev, B, S, C, N, seed=9)

    def shifted(t):
        flat = torch.empty(t.numel() + 1, device=dev)
        v = flat[1:].view(t.shape)
        v.copy_(t)
        assert v.data_ptr() % 16 != 0 and v.is_contiguous()
        return v

    y, h, hs = scan_ops.scan_forward(*ins, 256, save=True)
    y2, h2, hs2 = scan_ops.scan_forward(*map(shifted, ins), 256, save=True)
    assert torch.equal(y, y2) and torch.equal(h, h2) and torch.equal(hs, hs2)
    g = torch.Generator(device=dev).manual_seed(3)
    dy = torch.randn((B, S, C), generator=g, device=dev)
    dh = torch.randn((B, C, N), generator=g, device=dev)
    got = scan_ops.selective_scan_bwd(*ins[:5], hs, dy, dh)
    again = scan_ops.selective_scan_bwd(*map(shifted, (*ins[:5], hs, dy, dh)))
    for a, b in zip(got, again):
        assert torch.equal(a, b)


def test_selective_scan_raises_instead_of_falling_back(dev):
    """On the card the wrappers launch the kernels or raise: a state they
    do not take, bf16, a strided operand, saved states of the wrong shape
    for the backward; nothing is launched and no plain version is run."""
    x, dt, A, Bm, Cm, h0 = _scan_case(dev, 2, 40, 64, 16)
    n0, b0 = scan_ops.launches, scan_ops.bwd_launches
    with pytest.raises(ValueError, match="multiple of 8"):
        scan_ops.selective_scan(x, dt, *(t[..., :12].contiguous()
                                         for t in (A, Bm, Cm, h0)), 16)
    with pytest.raises(ValueError, match="float32"):
        scan_ops.selective_scan(x.to(torch.bfloat16), dt, A, Bm, Cm, h0, 16)
    with pytest.raises(ValueError, match="contiguous"):
        scan_ops.selective_scan(x.transpose(0, 1).contiguous().transpose(
            0, 1), dt, A, Bm, Cm, h0, 16)
    with pytest.raises(ValueError, match="hs must be"):
        scan_ops.selective_scan_bwd(x, dt, A, Bm, Cm, h0[:, None], x, h0)
    assert (scan_ops.launches, scan_ops.bwd_launches) == (n0, b0)


SCAN_BWD_SHAPES = [(2, 77, 100, 16), (1, 300, 256, 16), (3, 65, 70, 24),
                   (2, 130, 96, 32), (1, 70, 40, 64), (1, 1, 33, 8),
                   (1, 7, 64, 16), (2, 17, 130, 16), (8, 53, 64, 16),
                   (1, 40, 72, 40), (2, 33, 128, 48), (1, 20, 36, 56)]


@pytest.mark.parametrize("B,S,C,N", SCAN_BWD_SHAPES)
def test_selective_scan_backward_matches_both_plain_versions(dev, B, S, C,
                                                            N):
    """``SelectiveScan`` on the card, with a nonzero h0 and dh_last, S of
    one step, below one 16-step interval, just past one and several off the
    boundary, C off the 64-channel block (and not a multiple of 4), N from
    8 to 64 (every sub-tile length) and B up to 8: the
    forward that saves the tile states gives the serving forward's y and
    h_last bit for bit (one launch), the backward (one call: the reverse
    walk and the sums of its partials) gives dx, ddt, dA, dB, dC and dh0
    each within 1e-4 of its largest value of ``selective_scan_bwd_ref`` on
    the same saved states and within 1e-3 of autograd through
    ``selective_scan_ref``, and two backward calls give the same bits."""
    ins = _scan_case(dev, B, S, C, N, seed=S + N)
    g = torch.Generator(device=dev).manual_seed(1)
    dy = torch.randn((B, S, C), generator=g, device=dev)
    dh = torch.randn((B, C, N), generator=g, device=dev)
    leaves = [t.clone().requires_grad_() for t in ins]
    n0, b0 = scan_ops.launches, scan_ops.bwd_launches
    y, h = scan_ops.selective_scan(*leaves, 256)
    assert type(y.grad_fn).__name__ == "SelectiveScanBackward"
    assert scan_ops.launches == n0 + 1
    y0, h0 = scan_ops.selective_scan(*ins, 256)
    assert torch.equal(y.detach(), y0) and torch.equal(h.detach(), h0)
    got = torch.autograd.grad((y, h), leaves, (dy, dh))
    assert scan_ops.bwd_launches == b0 + 1
    _, _, hs = scan_ops.scan_forward(*ins, 256, save=True)
    assert hs.shape == (B, -(-S // scan_ops.TS), C, N)
    again = scan_ops.selective_scan_bwd(*ins[:5], hs, dy, dh)
    want = scan_ref.selective_scan_bwd_ref(*ins[:5], hs, dy, dh)
    oracle_in = [t.clone().requires_grad_() for t in ins]
    oracle = torch.autograd.grad(
        scan_ref.selective_scan_ref(*oracle_in, 256), oracle_in, (dy, dh))
    for name, a, b, w, o in zip(("dx", "ddt", "dA", "dB", "dC", "dh0"), got,
                                again, want, oracle):
        assert torch.equal(a, b), name
        assert _rel(a, w) < 1e-4, (name, _rel(a, w))
        assert _rel(a, o) < 1e-3, (name, _rel(a, o))


def test_selective_scan_backward_training_shape(dev):
    """jamba's training layer (B 2, S 2048, C 8192, N 16): the backward
    kernel within 1e-4 of ``selective_scan_bwd_ref`` on the kernel's saved
    states, two calls bit-equal."""
    ins = _scan_case(dev, 2, 2048, 8192, 16, seed=5)
    g = torch.Generator(device=dev).manual_seed(2)
    dy = torch.randn((2, 2048, 8192), generator=g, device=dev)
    dh = torch.randn((2, 8192, 16), generator=g, device=dev)
    _, _, hs = scan_ops.scan_forward(*ins, 256, save=True)
    got = scan_ops.selective_scan_bwd(*ins[:5], hs, dy, dh)
    again = scan_ops.selective_scan_bwd(*ins[:5], hs, dy, dh)
    want = scan_ref.selective_scan_bwd_ref(*ins[:5], hs, dy, dh)
    for name, a, b, w in zip(("dx", "ddt", "dA", "dB", "dC", "dh0"), got,
                             again, want):
        assert torch.equal(a, b), name
        assert _rel(a, w) < 1e-4, (name, _rel(a, w))


def test_mamba1_mixer_grads_on_card_match_host(dev):
    """jamba smoke's Mamba-1 mixer (f32) under autograd, through the scan
    kernels on the card against the plain versions on the host: the output
    and every parameter's gradient within 1e-4, one forward launch and one
    backward call."""
    from repro_torch.models.mamba import mamba1_mixer
    cfg = dataclasses.replace(smoke_config(get_config("jamba-v0.1-52b")),
                              param_dtype="float32")
    p = init_params(cfg, seed=0, device="cpu")["layers"][0]["mamba"]
    g = torch.Generator().manual_seed(0)
    x = torch.randn((2, 2 * cfg.ssm.chunk + 9, cfg.d_model), generator=g)
    dout = torch.randn(x.shape, generator=g)
    outs = {}
    for device in ("cpu", dev):
        pd = {k: v.to(device).requires_grad_() for k, v in p.items()}
        n0, b0 = scan_ops.launches, scan_ops.bwd_launches
        out = mamba1_mixer(cfg, pd, x.to(device))
        grads = torch.autograd.grad(out, list(pd.values()), dout.to(device))
        outs[str(device)] = (out.detach().cpu(), [t.cpu() for t in grads],
                             (scan_ops.launches - n0,
                              scan_ops.bwd_launches - b0))
    (o_h, g_h, n_h), (o_d, g_d, n_d) = outs["cpu"], outs[str(dev)]
    assert n_h == (0, 0) and n_d == (1, 1)
    assert _rel(o_d, o_h) < TOL[torch.float32]
    for a, b in zip(g_d, g_h):
        assert _rel(a, b) < TOL[torch.float32]


def test_mamba1_mixer_on_card_matches_host(dev):
    """jamba smoke's Mamba-1 mixer (f32) with its decode state, through
    the kernel on the card against the plain version on the host, at a
    prompt of three chunks and a ragged tail."""
    from repro_torch.models.mamba import mamba1_mixer
    cfg = dataclasses.replace(smoke_config(get_config("jamba-v0.1-52b")),
                              param_dtype="float32")
    p = init_params(cfg, seed=0, device="cpu")["layers"][0]["mamba"]
    x = torch.randn((2, 3 * cfg.ssm.chunk + 5, cfg.d_model),
                    generator=torch.Generator().manual_seed(0))
    out, state = mamba1_mixer(cfg, p, x, return_state=True)
    n0 = scan_ops.launches
    outd, stated = mamba1_mixer(cfg, tree_map(lambda t: t.to(dev), p),
                                x.to(dev), return_state=True)
    assert scan_ops.launches == n0 + 1
    assert _rel(outd.cpu(), out) < TOL[torch.float32]
    for name in ("conv_x", "ssm"):
        assert _rel(stated[name].cpu(), state[name]) < TOL[torch.float32]


# ------------------------------------------- flash backward and forward lse
def _bwd_case(dev, dtype, B, H, Hk, Tq, dh, dv, Tk=None, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    Tk = Tq if Tk is None else Tk

    def t(*shape):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    return (t(B, H, Tq, dh), t(B, Hk, Tk, dh), t(B, Hk, Tk, dv),
            t(B, H, Tq, dv))


MASKS = [(True, 0, 0.0), (True, 64, 0.0), (False, 0, 0.0), (True, 0, 30.0),
         (True, 32, 50.0), (False, 48, 0.0)]
BWD_SHAPES = [(128, 4, 2, 64, 64), (100, 8, 2, 128, 128), (37, 4, 1, 16, 16),
              (50, 2, 2, 32, 16), (200, 6, 3, 128, 128), (70, 4, 4, 24, 40)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal,window,softcap", MASKS)
@pytest.mark.parametrize("T,H,Hk,dh,dv", BWD_SHAPES)
def test_flash_fwd_lse_matches_plain(dev, dtype, causal, window, softcap, T,
                                     H, Hk, dh, dv):
    """lse against the plain version (f32 both: the same products, other
    sum order); o equals the serving forward's bit for bit."""
    q, k, v, _ = _bwd_case(dev, dtype, 2, H, Hk, T, dh, dv)
    kw = dict(scale=dh ** -0.5, causal=causal, window=window,
              softcap=softcap)
    n0, l0 = flash_ops.launches, flash_ops.lse_launches
    o, lse = flash_ops.attend_fwd_lse(q, k, v, **kw)
    assert (flash_ops.launches, flash_ops.lse_launches) == (n0, l0 + 1)
    assert lse.dtype == torch.float32 and lse.shape == (2, H, T)
    torch.testing.assert_close(o, flash_ops.attend(q, k, v, **kw), rtol=0,
                               atol=0)
    _, want = flash_ref.flash_attention_fwd_lse_ref(q, k, v, **kw)
    torch.testing.assert_close(lse, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal,window,softcap", MASKS)
@pytest.mark.parametrize("T,H,Hk,dh,dv", BWD_SHAPES)
def test_flash_bwd_kernel_matches_plain(dev, dtype, causal, window, softcap,
                                        T, H, Hk, dh, dv):
    """dq, dk, dv against the plain recompute formula on the same o and lse:
    within 1e-4 (f32) or 3e-2 (bf16: p and ds enter the second products
    rounded to bf16; tests/test_kernels.py's bf16 tolerance) of each
    gradient's largest value. dh = dv = 64, 128 in bf16 take the tensor
    cores; the other shapes and f32 the CUDA cores."""
    q, k, v, do = _bwd_case(dev, dtype, 2, H, Hk, T, dh, dv, seed=1)
    kw = dict(scale=dh ** -0.5, causal=causal, window=window,
              softcap=softcap)
    o, lse = flash_ref.flash_attention_fwd_lse_ref(q, k, v, **kw)
    n0 = flash_ops.bwd_launches
    got = flash_ops.attend_bwd(q, k, v, o, lse, do, **kw)
    assert flash_ops.bwd_launches == n0 + 1
    want = flash_ref.flash_attention_bwd_ref(q, k, v, o, lse, do, **kw)
    for name, gt, w, x in zip(("dq", "dk", "dv"), got, want, (q, k, v)):
        assert gt.shape == x.shape and gt.dtype == x.dtype, name
        assert _rel(gt, w) < TOL[dtype], (name, _rel(gt, w))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_bwd_rows_without_live_keys(dev, dtype):
    """Causal + window with Tq > Tk + window: rows past Tk + window - 1 see
    no key. Their lse is log(1e-30), their o and dq are 0."""
    q, k, v, do = _bwd_case(dev, dtype, 1, 4, 2, 100, 64, 64, Tk=20)
    kw = dict(scale=0.125, causal=True, window=16, softcap=0.0)
    o, lse = flash_ops.attend_fwd_lse(q, k, v, **kw)
    dead = slice(35, 100)
    assert torch.all(o[:, :, dead] == 0)
    torch.testing.assert_close(lse[:, :, dead],
                               torch.full_like(lse[:, :, dead],
                                               float(np.log(1e-30))))
    dq, dk, dv = flash_ops.attend_bwd(q, k, v, o, lse, do, **kw)
    assert torch.all(dq[:, :, dead] == 0)
    want = flash_ref.flash_attention_bwd_ref(q, k, v, o, lse, do, **kw)
    for g_, w in zip((dq, dk, dv), want):
        assert _rel(g_, w) < TOL[dtype]


def test_flash_bwd_strided_views(dev):
    """Head-transposed views (the training block's layout) give the grads
    of contiguous inputs, each in its input's memory order."""
    g = torch.Generator(device=dev).manual_seed(2)
    B, T, H, Hk, dh = 2, 130, 8, 2, 128
    dt = torch.bfloat16
    q, do = (torch.randn((B, T, H, dh), generator=g, device=dev).to(dt)
             for _ in range(2))
    k, v = (torch.randn((B, T, Hk, dh), generator=g, device=dev).to(dt)
            for _ in range(2))
    views = [x.permute(0, 2, 1, 3) for x in (q, k, v, do)]
    o, lse = flash_ops.attend_fwd_lse(*views[:3], scale=0.1)
    got = flash_ops.attend_bwd(*views[:3], o, lse, views[3], scale=0.1)
    want = flash_ops.attend_bwd(*(x.contiguous() for x in views[:3]),
                                o.contiguous(), lse, views[3].contiguous(),
                                scale=0.1)
    for a, b in zip(got, want):
        assert a.permute(0, 2, 1, 3).is_contiguous()
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_flash_bwd_training_shape(dev):
    """The training path's shape (B=4, T=2048, 32 query heads over 8, dh
    128, causal, bf16, head-transposed views): dq, dk, dv within 3e-2 of
    the plain version's largest value, and two calls bit-equal."""
    g = torch.Generator(device=dev).manual_seed(7)
    B, T, H, Hk, dh = 4, 2048, 32, 8, 128
    dt = torch.bfloat16
    q, do = (torch.randn((B, T, H, dh), generator=g, device=dev).to(dt)
             for _ in range(2))
    k, v = (torch.randn((B, T, Hk, dh), generator=g, device=dev).to(dt)
            for _ in range(2))
    q, k, v, do = (x.permute(0, 2, 1, 3) for x in (q, k, v, do))
    kw = dict(scale=dh ** -0.5, causal=True)
    o, lse = flash_ops.attend_fwd_lse(q, k, v, **kw)
    got = flash_ops.attend_bwd(q, k, v, o, lse, do, **kw)
    again = flash_ops.attend_bwd(q, k, v, o, lse, do, **kw)
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    want = flash_ref.flash_attention_bwd_ref(q, k, v, o, lse, do, **kw)
    for name, gt, w in zip(("dq", "dk", "dv"), got, want):
        assert _rel(gt, w) < TOL[dt], (name, _rel(gt, w))


FLASH_TRAIN_SHAPES = [  # name, B, Tq, Tk, H, Hk, dh, causal
    ("whisper encoder", 8, 1500, 1500, 20, 20, 64, False),
    ("whisper decoder self", 8, 448, 448, 20, 20, 64, True),
    ("whisper cross", 8, 448, 1500, 20, 20, 64, False),
    ("internvl2", 4, 2048, 2048, 48, 8, 128, True)]


@pytest.mark.parametrize("name,B,Tq,Tk,H,Hk,dh,causal", FLASH_TRAIN_SHAPES)
def test_flash_bwd_new_training_shapes(dev, name, B, Tq, Tk, H, Hk, dh,
                                       causal):
    """The flash backward at whisper's training shapes (G 1, dh 64: the
    non-causal encoder, the causal decoder, the cross attention with Tq ≠
    Tk) and internvl2's G 6, bf16 head-transposed views as ``attend``
    passes them: the mma.sync route, dq, dk, dv within 3e-2 of the plain
    version's largest value, two calls bit-equal."""
    g = torch.Generator(device=dev).manual_seed(Tq + Tk)
    dt = torch.bfloat16
    q, do = (torch.randn((B, Tq, H, dh), generator=g, device=dev).to(dt)
             .permute(0, 2, 1, 3) for _ in range(2))
    k, v = (torch.randn((B, Tk, Hk, dh), generator=g, device=dev).to(dt)
            .permute(0, 2, 1, 3) for _ in range(2))
    assert flash_ops.bwd_route(dt, dh, dh, flash_ops._aligned(q, k, v, do)) \
        == "mma"
    kw = dict(scale=dh ** -0.5, causal=causal)
    o, lse = flash_ops.attend_fwd_lse(q, k, v, **kw)
    got = flash_ops.attend_bwd(q, k, v, o, lse, do, **kw)
    again = flash_ops.attend_bwd(q, k, v, o, lse, do, **kw)
    want = flash_ref.flash_attention_bwd_ref(q, k, v, o, lse, do, **kw)
    for gname, a, b, w in zip(("dq", "dk", "dv"), got, again, want):
        assert torch.equal(a, b), gname
        assert _rel(a, w) < TOL[dt], (gname, _rel(a, w))


def _one_call_kernels(fn) -> dict:
    """{kernel label: launches} on the card during one call of ``fn``,
    from torch.profiler; a few sleep kernels first, which some hosts'
    profilers lose in place of the first real record."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(4):
            torch.cuda._sleep(1000)
        fn()
        torch.cuda.synchronize()
        time.sleep(0.02)
    counts = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA and \
                "spin_kernel" not in e.name:
            label = _build.kernel_label(e.name)
            counts[label] = counts.get(label, 0) + 1
    return counts


@pytest.mark.parametrize("T,H,Hk,causal,window,softcap", [
    (300, 4, 4, True, 0, 0.0), (300, 4, 4, True, 64, 0.0),
    (300, 4, 4, True, 0, 30.0), (300, 4, 4, False, 0, 0.0),
    (1000, 4, 4, True, 200, 0.0), (300, 4, 2, True, 0, 0.0)])
def test_flash_bwd_mla_dims_tensor_cores(dev, T, H, Hk, causal, window,
                                         softcap):
    """MLA's backward shape (dqk 192 = nope 128 + rope 64, dv 128) on the
    mma.sync route: q, k and do head-transposed views, v the tail of the
    up-projected (nope + v) rows as ``mla_attention`` passes it (256 bytes
    into each row, no copy); ragged T, causal with and without a window, a
    softcap, non-causal, and a group of 2. dq, dk, dv within 3e-2 of the
    plain version's largest value, two calls bit-equal, one launch of each
    pass a call."""
    g = torch.Generator(device=dev).manual_seed(T + window)
    dt = torch.bfloat16

    def t(h, d):
        return torch.randn((2, T, h, d), generator=g, device=dev).to(dt)

    q, k, up, do = t(H, 192), t(Hk, 192), t(Hk, 256), t(H, 128)
    q, k, v, do = (x.permute(0, 2, 1, 3) for x in (q, k, up[..., 128:], do))
    assert flash_ops.bwd_route(dt, 192, 128, flash_ops._aligned(q, k, v, do)) \
        == "mma"
    kw = dict(scale=192 ** -0.5, causal=causal, window=window,
              softcap=softcap)
    o, lse = flash_ops.attend_fwd_lse(q, k, v, **kw)
    n0 = flash_ops.bwd_launches
    got = flash_ops.attend_bwd(q, k, v, o, lse, do, **kw)
    assert flash_ops.bwd_launches == n0 + 1
    assert all(torch.equal(a, b) for a, b in
               zip(got, flash_ops.attend_bwd(q, k, v, o, lse, do, **kw)))
    want = flash_ref.flash_attention_bwd_ref(q, k, v, o, lse, do, **kw)
    for name, gt, w, x in zip(("dq", "dk", "dv"), got, want, (q, k, v)):
        assert gt.shape == x.shape and gt.dtype == dt, name
        assert _rel(gt, w) < TOL[dt], (name, _rel(gt, w))
    counts = _one_call_kernels(
        lambda: flash_ops.attend_bwd(q, k, v, o, lse, do, **kw))
    assert counts == {"bwd_dq_mma<192, 128>": 1, "bwd_dkv_mma<192, 128>": 1,
                      "delta_kernel<__nv_bfloat16>": 1}, counts


@pytest.mark.parametrize("T,window,softcap", [
    (300, 4096, 0.0), (1000, 100, 0.0), (5000, 4096, 0.0), (300, 0, 30.0),
    (777, 64, 50.0)])
def test_flash_fwd_dh80_padded_wgmma(dev, monkeypatch, T, window, softcap):
    """h2o-danube-1.8b's head dim (dh = dv = 80, 8 query heads over 2 here)
    on the wgmma route, the head dim zero-filled to 128 in shared memory:
    out and lse against the plain versions (q scaled so the scores pass a
    softcap), ragged T, window 4096 and short windows. The output is a
    view of a (B, T, H, 128) buffer full of NaN: every column past 80 of
    each head must still be NaN after the call (the store writes the
    caller's 80 columns of a row, not the instance's 128)."""
    B, H, Hk, d = 2, 8, 2, 80
    g = torch.Generator(device=dev).manual_seed(T + window)
    dt = torch.bfloat16
    gain = 20.0 if softcap else 1.0
    q = (gain * torch.randn((B, T, H, d), generator=g, device=dev)).to(dt)
    k, v = (torch.randn((B, T, Hk, d), generator=g, device=dev).to(dt)
            for _ in range(2))
    q, k, v = (x.permute(0, 2, 1, 3) for x in (q, k, v))
    assert flash_ops.fwd_route(dt, d, d, flash_ops._aligned(q, k, v)) == \
        "wgmma"
    kw = dict(scale=d ** -0.5, causal=True, window=window, softcap=softcap)
    bufs = []

    def nan_view(x, shape):
        Bo, Ho, To, do = shape
        buf = torch.full((Bo, To, Ho, 128), float("nan"), dtype=x.dtype,
                         device=x.device)
        bufs.append(buf)
        return buf[..., :do].permute(0, 2, 1, 3)

    monkeypatch.setattr(flash_ops, "_empty_like_order", nan_view)
    n0 = flash_ops.launches
    got = flash_ops.attend(q, k, v, **kw)
    assert flash_ops.launches == n0 + 1
    o, lse = flash_ops.attend_fwd_lse(q, k, v, **kw)
    monkeypatch.undo()
    for buf in bufs:
        assert torch.isnan(buf[..., 80:]).all()
        assert not torch.isnan(buf[..., :80]).any()
    assert torch.equal(o, got)
    want = flash_ref.flash_attention_ref(q, k, v, **kw)
    torch.testing.assert_close(got.float(), want.float(), rtol=3e-2,
                               atol=3e-2)
    _, lse_r = flash_ref.flash_attention_fwd_lse_ref(q, k, v, **kw)
    torch.testing.assert_close(lse, lse_r, rtol=1e-4, atol=1e-4)


def test_flash_bwd_rejects_bad_inputs(dev):
    q, k, v, do = _bwd_case(dev, torch.float32, 1, 2, 2, 16, 32, 32)
    o, lse = flash_ops.attend_fwd_lse(q, k, v, scale=0.2)
    with pytest.raises(ValueError):
        flash_ops.attend_bwd(q, k, v, o, lse.double(), do, scale=0.2)
    with pytest.raises(ValueError):
        flash_ops.attend_bwd(q, k, v, o, lse, do[:, :, :8], scale=0.2)
    with pytest.raises(ValueError):
        flash_ops.attend_bwd(q, k, v, o.to(torch.bfloat16), lse, do,
                             scale=0.2)
    big = torch.randn((1, 2, 16, 320), device=dev)
    with pytest.raises(ValueError):
        flash_ops.attend_bwd(big, big, big, big, lse, big, scale=0.2)


# ------------------------------------------------------------- training
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attend_autograd_on_card_matches_plain_autograd(dev, dtype):
    """``attend`` under autograd (FlashAttention: the lse forward and the
    backward kernel; the tensor-core path in bf16 at dh = 128) against
    autograd through the plain forward on the card."""
    from repro_torch.models.attention import attend
    g = torch.Generator(device=dev).manual_seed(3)
    B, T, Hkv, G, dh = 2, 300, 2, 4, 128

    def t(*shape):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    q, k, v = t(B, T, Hkv, G, dh), t(B, T, Hkv, dh), t(B, T, Hkv, dh)
    do = t(B, T, Hkv, G, dh)
    kw = dict(scale=dh ** -0.5, causal=True, window=100, softcap=30.0)
    got = torch.autograd.grad(attend(*(x.requires_grad_() for x in
                                        (q, k, v)), **kw), (q, k, v), do)

    def plain(q, k, v):
        out = flash_ref.flash_attention_ref(
            q.reshape(B, T, Hkv * G, dh).permute(0, 2, 1, 3),
            k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3), **kw)
        return out.permute(0, 2, 1, 3).reshape(B, T, Hkv, G, dh)

    want = torch.autograd.grad(plain(q, k, v), (q, k, v), do)
    for a, b in zip(got, want):
        assert a.dtype == dtype and _rel(a, b) < TOL[dtype]


@pytest.mark.parametrize("arch,dtype", [
    ("mistral-nemo-12b", "float32"), ("mistral-nemo-12b", "bfloat16"),
    ("phi3.5-moe-42b-a6.6b", "float32"), ("deepseek-v2-236b", "float32"),
    ("mamba2-130m", "float32")])
def test_train_step_on_card_matches_host(dev, arch, dtype):
    """One smoke-config train step on the card against the same step on the
    host (plain versions). Launches: the lse forward twice per attention
    layer (the step and its remat recompute) and the backward once; the
    grouped GEMM 12 times per MoE layer (3 products, each in the forward,
    the recompute and twice in the backward); the SSD kernel twice per
    Mamba-2 layer (its backward runs the plain version). f32: loss to 1e-5
    relative, params to 2.5·lr at most and 1e-6 in the median; bf16: the
    loss to the bf16 logits tolerance."""
    from repro_torch.models.transformer import block_cfgs
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.step import make_state, make_train_step
    cfg = dataclasses.replace(smoke_config(get_config(arch)),
                              param_dtype=dtype)
    params = init_params(cfg, seed=0, device="cpu")
    toks = torch.tensor(np.random.default_rng(0).integers(0, cfg.vocab,
                                                          (4, 65)))
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:],
             "mask": torch.ones((4, 64))}
    ocfg = OptConfig(lr=1e-3, warmup_steps=0)
    counts = ((flash_ops, "lse_launches"), (flash_ops, "bwd_launches"),
              (gg_ops, "launches"), (ssd_ops, "launches"))
    out = {}
    for device in ("cpu", dev):
        state = make_state(tree_map(lambda x: x.to(device, copy=True), params),
                           ocfg)
        n = [getattr(mod, name) for mod, name in counts]
        state, m = make_train_step(cfg, ocfg)(
            state, {k: x.to(device) for k, x in batch.items()})
        launched = tuple(getattr(mod, name) - n0
                         for (mod, name), n0 in zip(counts, n))
        out[str(device)] = (float(m["loss"]), tree_leaves(state["params"]),
                            launched)
    (l_h, p_h, n_h), (l_d, p_d, n_d) = out["cpu"], out[str(dev)]
    bcs = block_cfgs(cfg)
    attn = sum(bc.mixer == "attn" for bc in bcs)
    moe = sum(bc.ffn == "moe" for bc in bcs)
    ssm = sum(bc.mixer == "mamba" for bc in bcs)
    assert n_h == (0, 0, 0, 0)
    assert n_d == (2 * attn, attn, 12 * moe, 2 * ssm)
    if dtype == "float32":
        assert abs(l_d - l_h) <= 1e-5 * l_h
        diff = torch.cat([(a.detach().cpu() - b.detach()).abs().reshape(-1)
                          for a, b in zip(p_d, p_h)])
        assert float(diff.max()) <= 2.5 * ocfg.lr
        assert float(diff.median()) < 1e-6
    else:
        assert abs(l_d - l_h) <= 3e-2 * l_h


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "whisper-large-v3",
                                  "internvl2-26b"])
def test_train_step_new_families_on_card_match_host(dev, arch):
    """One f32 smoke-config train step of the families this port trains
    since the scan's backward (jamba: Mamba-1 + attention + MoE; whisper:
    the encoder-decoder; internvl2: the front end) on the card against the
    same step on the host (plain versions), on a ``synth_batch`` made on
    the host. Launches: the lse forward twice per attention (the step and
    its remat recompute; whisper: encoder self, decoder self and cross) and
    the flash backward once; the scan forward twice per Mamba-1 layer and
    its backward once; the grouped GEMM 12 times per MoE layer. Loss to
    1e-5 relative, params to 2.5·lr at most and 1e-6 in the median."""
    from repro_torch.models.model import synth_batch
    from repro_torch.models.transformer import block_cfgs
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.step import make_state, make_train_step
    cfg = dataclasses.replace(smoke_config(get_config(arch)),
                              param_dtype="float32")
    params = init_params(cfg, seed=0, device="cpu")
    batch = synth_batch(cfg, 2, 48, torch.Generator().manual_seed(0))
    ocfg = OptConfig(lr=1e-3, warmup_steps=0)
    counts = ((flash_ops, "lse_launches"), (flash_ops, "bwd_launches"),
              (scan_ops, "launches"), (scan_ops, "bwd_launches"),
              (gg_ops, "launches"))
    out = {}
    for device in ("cpu", dev):
        state = make_state(tree_map(lambda x: x.to(device, copy=True), params),
                           ocfg)
        n = [getattr(mod, name) for mod, name in counts]
        state, m = make_train_step(cfg, ocfg)(
            state, {k: x.to(device) for k, x in batch.items()})
        launched = tuple(getattr(mod, name) - n0
                         for (mod, name), n0 in zip(counts, n))
        out[str(device)] = (float(m["loss"]), tree_leaves(state["params"]),
                            launched)
    (l_h, p_h, n_h), (l_d, p_d, n_d) = out["cpu"], out[str(dev)]
    if cfg.enc_dec:
        attn, mamba, moe = cfg.n_enc_layers + 2 * cfg.n_layers, 0, 0
    else:
        bcs = block_cfgs(cfg)
        attn = sum(bc.mixer == "attn" for bc in bcs)
        mamba = sum(bc.mixer == "mamba" for bc in bcs)
        moe = sum(bc.ffn == "moe" for bc in bcs)
    assert n_h == (0, 0, 0, 0, 0)
    assert n_d == (2 * attn, attn, 2 * mamba, mamba, 12 * moe)
    assert abs(l_d - l_h) <= 1e-5 * l_h
    diff = torch.cat([(a.detach().cpu() - b.detach()).abs().reshape(-1)
                      for a, b in zip(p_d, p_h)])
    assert float(diff.max()) <= 2.5 * ocfg.lr
    assert float(diff.median()) < 1e-6


# ------------------------------------------- backwards of the training path
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("E,M,K,N", [(4, 13, 64, 48), (3, 100, 256, 128),
                                     (2, 40, 128, 64)])
def test_grouped_gemm_backward_matches_plain(dev, dtype, E, M, K, N):
    """``GroupedGemm``: dA = dC·Wᵀ and dW = Aᵀ·dC on the kernel, one launch
    a product (dW's sum over M padded with zero rows to a multiple of 8 in
    bf16: M 13 and 100), against autograd through the plain version."""
    g = torch.Generator(device=dev).manual_seed(M)
    a = torch.randn((E, M, K), generator=g, device=dev).to(dtype)
    w = (torch.randn((E, K, N), generator=g, device=dev) * K ** -0.5).to(dtype)
    dc = torch.randn((E, M, N), generator=g, device=dev).to(dtype)
    a1, w1 = a.clone().requires_grad_(), w.clone().requires_grad_()
    n0 = gg_ops.launches
    out = gg_ops.GroupedGemm.apply(a1, w1)
    assert gg_ops.launches == n0 + 1
    da, dw = torch.autograd.grad(out, (a1, w1), dc)
    assert gg_ops.launches == n0 + 3
    a2, w2 = a.clone().requires_grad_(), w.clone().requires_grad_()
    want = torch.autograd.grad(gg_ref.grouped_gemm_ref(a2, w2), (a2, w2), dc)
    for got, ref in zip((da, dw), want):
        assert got.dtype == dtype and got.shape == ref.shape
        assert _rel(got, ref) < TOL[dtype]
    n0 = gg_ops.launches
    da_only, = torch.autograd.grad(gg_ops.GroupedGemm.apply(a1, w), a1, dc)
    assert gg_ops.launches == n0 + 2 and torch.equal(da_only, da)


@pytest.mark.parametrize("K,N", [(4096, 14336), (14336, 4096)])
def test_grouped_gemm_backward_jamba_shapes(dev, K, N):
    """``GroupedGemm`` in bf16 at jamba's expert products under training (16
    experts, capacity 640 of 2 x 2048 tokens at top-2 and factor 1.25; up
    (4096 → 14336) and down (14336 → 4096)): dA and dW within 3e-2 of the
    plain version's largest value, one launch a product."""
    E, M = 16, 640
    g = torch.Generator(device=dev).manual_seed(K)
    dt = torch.bfloat16
    a = torch.randn((E, M, K), generator=g, device=dev).to(dt)
    w = (torch.randn((E, K, N), generator=g, device=dev) * K ** -0.5).to(dt)
    dc = torch.randn((E, M, N), generator=g, device=dev).to(dt)
    a1, w1 = a.clone().requires_grad_(), w.clone().requires_grad_()
    n0 = gg_ops.launches
    da, dw = torch.autograd.grad(gg_ops.GroupedGemm.apply(a1, w1), (a1, w1),
                                 dc)
    assert gg_ops.launches == n0 + 3
    for got, want in ((da, gg_ref.grouped_gemm_ref(dc, w.transpose(1, 2))),
                      (dw, gg_ref.grouped_gemm_ref(a.transpose(1, 2), dc))):
        assert got.dtype == dt and got.shape == want.shape
        assert _rel(got, want) < TOL[dt]


@pytest.mark.parametrize("P,N,route", [(64, 128, "mma"), (16, 32, "mma"),
                                       (72, 40, "f32")])
def test_ssd_intra_chunk_grads_on_card(dev, P, N, route):
    """``SsdIntraChunk``: the forward launches the kernel once (y and st as
    the plain version's), the backward (the plain version recomputed) gives
    autograd's gradients through the plain version, B and C shared by the
    heads with stride 0 (their gradients summed over the heads)."""
    G, H, Q = 3, 4, 64
    x, cs, B, C = _ssd_case(dev, G, H, Q, P, N, seed=P)
    leaves = [t.detach().requires_grad_() for t in (x, cs, B[:, :1], C[:, :1])]

    def args():
        return (*leaves[:2], *(t.expand(G, H, Q, N) for t in leaves[2:]))

    xa, _, ba, ca = args()
    assert ssd_ops.route_of(xa, ba, ca) == route
    n0 = ssd_ops.launches
    y, st = ssd_ops.intra_chunk_autograd(*args())
    assert ssd_ops.launches == n0 + 1
    g = torch.Generator(device=dev).manual_seed(1)
    dy = torch.randn(y.shape, generator=g, device=dev)
    dst = torch.randn(st.shape, generator=g, device=dev)
    got = torch.autograd.grad((y, st), leaves, (dy, dst))
    assert ssd_ops.launches == n0 + 1
    yr, str_ = ssd_ref.ssd_intra_chunk_ref(*args())
    assert _rel(y, yr) < 1e-4 and _rel(st, str_) < 1e-4
    want = torch.autograd.grad((yr, str_), leaves, (dy, dst))
    for a, b in zip(got, want):
        assert a.shape == b.shape and _rel(a, b) < 1e-5


# ------------------------------------- CUDA-core paged GQA above dh 128
@pytest.mark.parametrize("dtype,grp,dh", [
    (torch.float32, 2, 256), (torch.float32, 8, 256), (torch.float32, 5, 256),
    (torch.float32, 6, 256), (torch.float32, 3, 192), (torch.float32, 4, 136),
    (torch.bfloat16, 3, 200)])
@pytest.mark.parametrize("softcap", [0.0, 5.0])
def test_paged_core_kernel_above_dh128(dev, dtype, grp, dh, softcap):
    """paged_gqa_kernel's dh-256 instance (8 value dims a lane; dynamic
    shared memory, opted in past 48 KB at G 6 to 8) against the plain
    version, f32 and a bf16 head dim the tensor cores do not take."""
    assert paged_ops.gqa_route(dtype, grp, dh) == "f32"
    q, pk, pv, pt, pos = _paged_case(dev, dtype, 16, grp, dh)
    for base in (0, 8):
        n0 = paged_ops.launches
        got = paged_ops.paged_attend_gqa(q, pk, pv, pt, pos, base,
                                         page_size=16, scale=dh ** -0.5,
                                         softcap=softcap)
        assert paged_ops.launches == n0 + 1
        want = paged_ref.paged_flash_decode_gqa_ref(
            q, pk, pv, pt, pos, base, page_size=16, scale=dh ** -0.5,
            softcap=softcap)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)


def test_paged_core_kernel_gemma2_shape_f32(dev):
    """f32 paged decode at gemma2-2b's global layers (Hkv 4, G 2, dh 256,
    softcap 50, an 8192-key table, q scaled so the scores pass the cap)
    against ref.py."""
    B, hkv, grp, dh, ps, max_len = 4, 4, 2, 256, 16, 8192
    T = max_len // ps
    N = 1 + B * T
    rng = np.random.default_rng(0)
    g = torch.Generator(device=dev).manual_seed(0)
    q = 30 * torch.randn((B, hkv, grp, dh), generator=g, device=dev)
    pk = torch.randn((N, ps, hkv, dh), generator=g, device=dev)
    pv = torch.randn((N, ps, hkv, dh), generator=g, device=dev)
    table = torch.tensor(1 + rng.permutation(N - 1).reshape(B, T),
                         dtype=torch.int32, device=dev)
    pos = torch.tensor([8191, 0, 4095, 4096], dtype=torch.int32, device=dev)
    kw = dict(page_size=ps, scale=dh ** -0.5, softcap=50.0)
    o, m, l = paged_ops.paged_attend_gqa(q, pk, pv, table, pos, 0, **kw)
    o_r, m_r, l_r = paged_ref.paged_flash_decode_gqa_ref(q, pk, pv, table,
                                                         pos, 0, **kw)
    torch.testing.assert_close(m, m_r, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(l, l_r, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(o / l[..., None], o_r / l_r[..., None],
                               rtol=1e-4, atol=1e-4)


# -------------------------------------------- the tier pool on the card
def _overlap_first_captures(capturing, stepping) -> dict:
    """Hold the first graph capture of tier ``capturing`` open until tier
    ``stepping`` has made one whole step (admission, prefill, its own first
    quantum's capture) on its stream from its thread: the first quanta of
    a concurrent pool capture while the other tier steps. Returns flags
    the caller checks: both waits met."""
    import threading
    in_capture, stepped = threading.Event(), threading.Event()
    flags = {"capture_waited": False, "step_waited": False}
    graphs = capturing.engine.graphs
    real_capture, real_step = graphs._capture, stepping.engine.step

    def capture(fn):
        calls = [0]

        def held():
            calls[0] += 1                      # 1: warm-up, 2: captured
            if calls[0] == 2 and not in_capture.is_set():
                in_capture.set()
                flags["capture_waited"] = stepped.wait(120)
            fn()
        return real_capture(held)

    def step():
        if stepped.is_set():
            return real_step()
        flags["step_waited"] = in_capture.wait(120)
        try:
            return real_step()
        finally:
            stepped.set()

    graphs._capture = capture
    stepping.engine.step = step
    return flags


def _card_pool(cfg, params, concurrent):
    from repro_torch.serve.multi_engine import EngineTier, MultiEngine
    tiers = [EngineTier("short", Engine(cfg, params, paged=False,
                                        max_slots=4, max_len=64,
                                        decode_quantum=4)),
             EngineTier("long", Engine(cfg, params, paged=True, max_slots=4,
                                       max_len=256, page_size=8,
                                       decode_quantum=4))]
    meng = MultiEngine(tiers, concurrent=concurrent)
    meng.tracker.throughput = lambda name: 0.0     # routing at the priors
    for t in tiers:
        t.engine.tracker.f = lambda: 0.01
    return meng


def test_pool_concurrent_tiers_on_card(dev):
    """A dense and a paged smoke tier over one parameter tree, stepped
    serially and in two threads (each engine on its own stream), fresh
    engines each time: in the concurrent run the long tier's first capture
    stays open while the short tier makes a whole step (its own first
    capture included). Both runs: no health transition, the same
    assignments, streams and launch counts, one capture per width, every
    page back."""
    from repro_torch.serve import graphs
    cfg = smoke_config(get_config("mistral-nemo-12b"))
    params = init_params(cfg, seed=0, device=dev)
    rng = np.random.default_rng(0)
    lens = list(rng.integers(4, 40, 10)) + [150, 200]
    prompts = [rng.integers(0, cfg.vocab, int(n)).tolist() for n in lens]
    runs = []
    for concurrent in (False, True):
        meng = _card_pool(cfg, params, concurrent)
        flags = (_overlap_first_captures(meng.tiers[1], meng.tiers[0])
                 if concurrent else None)
        reqs = [Request(rid=i, prompt=p, max_new=12)
                for i, p in enumerate(prompts)]
        before = graphs.launch_counts()
        meng.run(reqs)
        torch.cuda.synchronize()
        delta = tuple(a - b for a, b in zip(graphs.launch_counts(), before))
        assert not meng.health_log and not meng.dead_letters, meng.health_log
        assert all(r.done and len(r.out) == 12 for r in reqs)
        assert all(meng.assigned[i] == "long" for i in (10, 11))
        for t in meng.tiers:
            eng = t.engine
            assert t.routed > 0
            assert eng.decode_captures == len(eng.widths_used) > 0
            assert all(r is None for r in eng.slot_req)
            if eng.paged:
                eng.alloc.check()
                assert len(eng.alloc.free) == eng.alloc.usable_pages
        if concurrent:
            assert flags == {"capture_waited": True, "step_waited": True}
        runs.append((dict(meng.assigned), [r.out for r in reqs], delta))
    (a_s, s_s, d_s), (a_c, s_c, d_c) = runs
    assert a_s == a_c and s_s == s_c
    assert d_s == d_c and any(d_c), (d_s, d_c)


# ------------------------------------------------- speculative decode: verify
SPEC_K1 = 5                # verify rows a slot: spec_k 4 + 1


@pytest.mark.parametrize("op", ["gqa_mma", "gqa_f32", "mla_wgmma"])
def test_paged_verify_rows_match_plain(dev, op):
    """A verify's call of the paged kernels: each slot's table repeated K
    times and its last committed position pos0 - 1 (B·K = 40 rows at the
    main path's 256-page table, 8 splits), the never-filled slot at pos0 0
    passing -1: equal to the plain version, and the empty rows merged to
    m = -1e30, l = 0, o = 0 across the splits. The tensor-core routes in
    bf16 (mistral's group 4 at dh 128; deepseek-v2's 128 heads at R 576)
    and the CUDA-core route in f32."""
    from repro_torch.serve.decode import _repeat_rows
    if op == "mla_wgmma":
        q, pool, pt, pos = _mla_main(dev)
        pools = (pool,)
    else:
        q, pk, pv, pt, pos = _gqa_main(dev)
        pools = (pk, pv)
        if op == "gqa_f32":
            q, pools = q.float(), tuple(p.float() for p in pools)
    pos0 = pos + 1                               # the empty slot: pos0 0
    ptf, posf = _repeat_rows(pt, pos0, SPEC_K1)
    B = pt.shape[0] * SPEC_K1
    g = torch.Generator(device=dev).manual_seed(1)
    q = torch.randn((B,) + tuple(q.shape[1:]), generator=g, device=dev).to(
        q.dtype)
    if op == "mla_wgmma":
        assert paged_ops.mla_route(q.dtype, 128, 576, 512, 16) == "wgmma"
        kw = dict(page_size=16, kv_lora=512, scale=192 ** -0.5)
        got = paged_ops.paged_attend_mla(q, pool, ptf, posf, 0, **kw)
        want = paged_ref.paged_flash_decode_mla_ref(
            q, pool.nan_to_num(), ptf, posf, 0, **kw)
    else:
        route = "mma" if op == "gqa_mma" else "f32"
        assert paged_ops.gqa_route(q.dtype, 4, 128) == route
        kw = dict(page_size=16, scale=128 ** -0.5, softcap=0.0)
        got = paged_ops.paged_attend_gqa(q, *pools, ptf, posf, 0, **kw)
        want = paged_ref.paged_flash_decode_gqa_ref(
            q, *(p.nan_to_num() for p in pools), ptf, posf, 0, **kw)
    assert paged_ops.split_plan(pt.shape[1], 16, paged_ops.GQA_PLAN if
                                "gqa" in op else paged_ops.MLA_PLAN)[0] > 1
    _close_partials(got, want)
    o, m, l = got
    empty = slice(SPEC_K1, 2 * SPEC_K1)          # MAIN_POS[1] = -1 → pos0 0
    assert torch.equal(posf[empty], torch.full_like(posf[empty], -1))
    assert torch.all(m[empty] == -1e30) and torch.all(l[empty] == 0) and \
        torch.all(o[empty] == 0)


def test_grouped_gemm_verify_stride0_prefill_path(dev):
    """MoE verify's expert product: B·K = 40 tokens broadcast over the
    experts with stride 0 reach the bf16 prefill path (M > DECODE_M) at
    deepseek-v2's expert shapes, equal to the contiguous copy's product and
    within 3e-2 of the plain version."""
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((40, 5120), generator=g, device=dev).to(torch.bfloat16)
    w = torch.randn((8, 5120, 1536), generator=g, device=dev).to(
        torch.bfloat16) * 0.02
    a = x.unsqueeze(0).expand(8, 40, 5120)
    assert a.stride(0) == 0 and gg_ops.route(a.dtype, 40) == "prefill"
    n0 = gg_ops.launches
    got = gg_ops.grouped_gemm(a, w)
    assert gg_ops.launches == n0 + 1
    torch.testing.assert_close(got, gg_ops.grouped_gemm(a.contiguous(), w),
                               rtol=0, atol=0)
    ref = gg_ref.grouped_gemm_ref(a, w)
    assert float((got.float() - ref.float()).abs().max() /
                 ref.float().abs().max()) < 3e-2


SPEC_ARCHS = ["mistral-nemo-12b", "deepseek-v2-236b", "gemma2-2b",
              "mamba2-130m", "jamba-v0.1-52b"]


@pytest.mark.parametrize("arch", SPEC_ARCHS)
def test_engine_spec_graphs_match_eager_and_host(dev, arch):
    """f32 smoke speculative engines (mistral with its one-layer draft, the
    others with an independent mistral smoke draft; spec_k 3; jamba: a
    Mamba-1 target, its staged states inside the captured quantum): replayed
    graphs (one capture per width) = the eager loop on the card = the host
    engine = the target-only engine, greedy, with equal launch counts; and
    sampled, graphs = eager."""
    from repro_torch.models.draft import draft_from_target
    cfg = dataclasses.replace(smoke_config(get_config(arch)),
                              param_dtype="float32")
    params = init_params(cfg, seed=0, device="cpu")
    if arch == "mistral-nemo-12b":
        dcfg, dparams = draft_from_target(cfg, params, 1)
    else:
        dcfg = dataclasses.replace(smoke_config(get_config(
            "mistral-nemo-12b")), param_dtype="float32")
        dparams = init_params(dcfg, seed=7, device="cpu")
    prompts, kw = _graph_workload(cfg)
    n = 24                                 # more quanta than widths
    plain, _, _ = _serve_counted(cfg, params, dev, prompts, kw, n)
    runs = {}
    for where, extra in (("host", dict(device="cpu")),
                         ("eager", dict(graphs=False)), ("graphs", {})):
        device = extra.pop("device", dev)
        runs[where] = _serve_counted(
            cfg, params, device, prompts, kw, n, draft_cfg=dcfg,
            draft_params=tree_map(lambda t: t.to(device), dparams),
            spec_k=3, **extra)
    assert runs["graphs"][0] == runs["eager"][0] == runs["host"][0] == plain
    g_eng, e_eng = runs["graphs"][1], runs["eager"][1]
    assert g_eng.decode_captures == len(g_eng.widths_used)
    assert g_eng.widths_used == e_eng.widths_used
    assert g_eng.quanta > g_eng.decode_captures
    assert g_eng.spec_proposed == e_eng.spec_proposed > 0
    assert runs["graphs"][2] == runs["eager"][2] and any(runs["graphs"][2])
    sampled = dict(temperature=0.8, top_k=50, sample_seed=3, draft_cfg=dcfg,
                   draft_params=tree_map(lambda t: t.to(dev), dparams),
                   spec_k=3)
    eager, _, _ = _serve_counted(cfg, params, dev, prompts, kw, n,
                                 graphs=False, **sampled)
    graph, eng, _ = _serve_counted(cfg, params, dev, prompts, kw, n,
                                   **sampled)
    assert eng.decode_captures == len(eng.widths_used)
    assert graph == eager


# ------------------------------ whisper and internvl2 (enc-dec, front end)
@pytest.mark.parametrize("T", [448, 1500])
def test_flash_wgmma_noncausal_mha_dh64(dev, T):
    """whisper's encoder attention: 20 heads over 20 (one query head a kv
    head), dh 64, no mask, a ragged last key tile at 1500, the (B, T, 20,
    64) projections as views: the wgmma route, one launch, within 3e-2 of
    the plain version, two calls bit-equal."""
    q, k, v = _fwd_views(dev, 2, T, 20, 20, 64, 64, seed=T)
    assert flash_ops._aligned(q, k, v)
    assert flash_ops.fwd_route(q.dtype, 64, 64, True) == "wgmma"
    kw = dict(scale=64 ** -0.5, causal=False)
    n0 = flash_ops.launches
    got = flash_ops.attend(q, k, v, **kw)
    assert flash_ops.launches == n0 + 1
    assert torch.equal(got, flash_ops.attend(q, k, v, **kw))
    want = flash_ref.flash_attention_ref(q, k, v, **kw)
    torch.testing.assert_close(got.float(), want.float(), rtol=3e-2,
                               atol=3e-2)


def _whisper_smoke():
    cfg = dataclasses.replace(smoke_config(get_config("whisper-large-v3")),
                              param_dtype="float32")
    return cfg, init_params(cfg, seed=0, device="cpu")


def test_whisper_prefill_on_card_matches_host(dev):
    """whisper smoke (f32): the encoder states and every layer's cross K/V
    of ``whisper_prefill`` on the card (the flash forward, non-causal)
    against the host's plain versions."""
    from repro_torch.serve.prefill import whisper_prefill
    cfg, params = _whisper_smoke()
    fr = torch.randn((2, 40, cfg.d_model),
                     generator=torch.Generator().manual_seed(1)) * 0.1
    enc, cache = whisper_prefill(cfg, params, fr)
    n0 = flash_ops.launches
    encd, cached = whisper_prefill(cfg, tree_map(lambda t: t.to(dev), params),
                                   fr.to(dev))
    assert flash_ops.launches == n0 + cfg.n_enc_layers
    assert _rel(encd.cpu(), enc) < TOL[torch.float32]
    for c, cd in zip(cache["dec_layers"], cached["dec_layers"]):
        for name in ("xk", "xv"):
            assert _rel(cd[name].cpu(), c[name]) < TOL[torch.float32]


def test_whisper_decode_step_on_card_matches_host(dev):
    """whisper smoke (f32): 20 greedy ``whisper_decode_step``s on the card
    (past ``max_decoder_len``) give the host's tokens, each step's logits
    within 1e-4."""
    from repro_torch.serve.decode import whisper_decode_step
    from repro_torch.serve.prefill import whisper_prefill
    cfg, params = _whisper_smoke()
    fr = torch.randn((2, 40, cfg.d_model),
                     generator=torch.Generator().manual_seed(2)) * 0.1
    runs = []
    for device in ("cpu", dev):
        p = tree_map(lambda t: t.to(device), params)
        _, cache = whisper_prefill(cfg, p, fr.to(device))
        tok = torch.tensor([1, 7], device=device)
        logits = []
        for t in range(20):
            lg, cache = whisper_decode_step(cfg, p, cache, tok,
                                            torch.full((2,), t,
                                                       device=device))
            tok = lg.argmax(-1)
            logits.append(lg.cpu())
        runs.append(logits)
    for a, b in zip(*runs):
        assert _rel(b, a) < TOL[torch.float32]
        assert torch.equal(a.argmax(-1), b.argmax(-1))


def test_internvl2_prefill_with_frontend_on_card_matches_host(dev):
    """internvl2 smoke: ``prefill(frontend_embed)`` on the card (the flash
    forward) against the host, exact-length in f32 (1e-4) and bucketed
    with ``prompt_len`` in bf16 (3e-2 of the largest logit)."""
    from repro_torch.serve.prefill import prefill
    for dtype, pl in (("float32", None), ("bfloat16", [12, 32])):
        cfg = dataclasses.replace(smoke_config(get_config("internvl2-26b")),
                                  param_dtype=dtype)
        params = init_params(cfg, seed=0, device="cpu")
        g = torch.Generator().manual_seed(3)
        toks = torch.randint(0, cfg.vocab, (2, 32), generator=g)
        fe = torch.randn((2, cfg.frontend_tokens, cfg.frontend_dim),
                         generator=g) * 0.1
        kw = {} if pl is None else dict(prompt_len=torch.tensor(pl),
                                        page_size=8)
        want, cache = prefill(cfg, params, toks, frontend_embed=fe, **kw)
        n0 = flash_ops.launches
        got, cached = prefill(cfg, tree_map(lambda t: t.to(dev), params),
                              toks.to(dev), frontend_embed=fe.to(dev),
                              **{n: t.to(dev) if torch.is_tensor(t) else t
                                 for n, t in kw.items()})
        assert flash_ops.launches == n0 + cfg.n_layers
        assert _rel(got.cpu(), want) < TOL[cfg.pdtype]
        if dtype == "float32":
            for c, cd in zip(cache["layers"], cached["layers"]):
                assert _rel(cd["k"].cpu(), c["k"]) < TOL[torch.float32]


def test_serve_launcher_internvl2_on_card(dev):
    """``python -m repro_torch.launch.serve --arch internvl2-26b`` serves
    the smoke config on the card (its default device) and exits 0."""
    import os
    import subprocess
    import sys
    from pathlib import Path
    src = Path(__file__).resolve().parents[1] / "src"
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "internvl2-26b", "--requests", "4", "--max-new", "4"],
        env=dict(os.environ, PYTHONPATH=str(src)), capture_output=True,
        text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.startswith("served 4 requests"), out.stdout


# ------------------------------- windowed MLA training; the gathered view
@pytest.mark.parametrize("window", [64, 200])
def test_flash_mla_window_fwd_bwd_match_plain(dev, window):
    """Windowed MLA training's attention: q/k dim 192, v dim 128, 16 heads
    at G = 1, causal with a window, bf16 head-transposed views. The forward
    that saves lse (the wgmma route) and the backward (the mma.sync
    passes at (192, 128)) against their plain versions: o within 3e-2,
    lse within 1e-2, dq, dk, dv within 3e-2 of the plain version's largest
    value; the window changes the result."""
    g = torch.Generator(device=dev).manual_seed(window)
    B, T, H, dt = 2, 700, 16, torch.bfloat16
    q, k = (torch.randn((B, T, H, 192), generator=g, device=dev).to(dt)
            .permute(0, 2, 1, 3) for _ in range(2))
    v, do = (torch.randn((B, T, H, 128), generator=g, device=dev).to(dt)
             .permute(0, 2, 1, 3) for _ in range(2))
    al = flash_ops._aligned(q, k, v, do)
    assert flash_ops.fwd_route(dt, 192, 128, al) == "wgmma"
    assert flash_ops.bwd_route(dt, 192, 128, al) == "mma"
    kw = dict(scale=192 ** -0.5, causal=True, window=window)
    o, lse = flash_ops.attend_fwd_lse(q, k, v, **kw)
    wo, wlse = flash_ref.flash_attention_fwd_lse_ref(q, k, v, **kw)
    assert _rel(o, wo) < TOL[dt]
    assert float((lse - wlse).abs().max()) < 1e-2
    full = flash_ops.attend(q, k, v, scale=kw["scale"], causal=True)
    assert _rel(o, full) > 0.1
    got = flash_ops.attend_bwd(q, k, v, o, lse, do, **kw)
    want = flash_ref.flash_attention_bwd_ref(q, k, v, o, lse, do, **kw)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        assert _rel(a, w) < TOL[dt], (name, _rel(a, w))


@pytest.mark.parametrize("arch", ["mistral-nemo-12b", "deepseek-v2-236b"])
def test_engine_gather_launches_no_paged_kernel(dev, arch):
    """The gathered-view engine (``paged_kernel=False``), f32 smoke: graphs
    (one capture, at the full table width) = eager = the host engine = the
    paged-kernel engine, and neither gathered run launches a paged
    kernel."""
    cfg = dataclasses.replace(smoke_config(get_config(arch)),
                              param_dtype="float32")
    params = init_params(cfg, seed=0, device="cpu")
    prompts, kw = _graph_workload(cfg)
    kernel, _, k_launch = _serve_counted(cfg, params, dev, prompts, kw)
    runs = {where: _serve_counted(cfg, params, device, prompts, kw,
                                  paged_kernel=False, **extra)
            for where, device, extra in (("host", "cpu", {}),
                                         ("eager", dev, dict(graphs=False)),
                                         ("graphs", dev, {}))}
    assert runs["graphs"][0] == runs["eager"][0] == runs["host"][0] == kernel
    g_eng = runs["graphs"][1]
    assert g_eng.decode_captures == 1
    assert set(g_eng.widths_used) == {g_eng.pages_per_slot}
    from repro_torch.serve import graphs
    names = [f"{mod.__name__}.{name}" for mod, name in graphs.COUNTERS]
    paged = [i for i, n in enumerate(names) if "paged_attention" in n]
    assert paged and any(k_launch[i] for i in paged)
    for where in ("eager", "graphs"):
        assert not any(runs[where][2][i] for i in paged), runs[where][2]
