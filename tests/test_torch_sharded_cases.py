"""The cases of ``test_torch_sharded_serve.py`` that run on each spawned
rank, and their inputs. This module imports no JAX, so a rank starts
without it; it holds no test of its own."""
import dataclasses
import os
import pickle
import time

import numpy as np
import torch

from repro_torch import configs as tconfigs
from repro_torch.models.moe import moe_block, moe_decode
from repro_torch.models.transformer import lm_hidden
from repro_torch.params import params_from_numpy
from repro_torch.serve import decode as tdec
from repro_torch.serve import engine as teng
from repro_torch.serve.prefill import prefill
from repro_torch.sharding import collectives as coll

ARCHS = ("mistral-nemo-12b", "phi3.5-moe-42b-a6.6b")
WIDE = dict(n_heads=16, n_kv_heads=4, param_dtype="float32")
ENGINE_KW = dict(max_slots=3, max_len=64, decode_quantum=4, paged=True,
                 page_size=8)
LENS = (4, 9, 17, 23, 5)
MAX_NEW = 6
PINNED_F = 0.5          # MoE capacity couples a prefill group's rows
MESHES = (2, 4)
SAMPLED = dict(temperature=0.8, top_k=20, sample_seed=5)
RANK_TIMEOUT = 240


def tcfg(arch):
    """The port's smoke config of ``arch``, widened (``WIDE``)."""
    return dataclasses.replace(
        tconfigs.smoke_config(tconfigs.get_config(arch)), **WIDE)


def _prompts(vocab):
    rng = np.random.default_rng(3)
    return [rng.integers(0, vocab, n).tolist() for n in LENS]


# ------------------------------------------------------------- the cases
# Inputs of each case come from numpy seeds, so a rank and the one-device
# reference make the same ones.
def _decode_inputs(cfg, B=3, T=4, ps=8, seed=0):
    """Pools of every layer, a page table, positions (the last slot at 0:
    only rank 0 holds a live key) and tokens."""
    rng = np.random.default_rng(seed)
    N = 1 + B * T
    shape = (N, ps, cfg.n_kv_heads, cfg.head_dim)
    pools = [{n: rng.normal(size=shape).astype(np.float32) * 0.5
              for n in ("k", "v")} for _ in range(cfg.n_layers)]
    pt = (1 + rng.permutation(N - 1).reshape(B, T)).astype(np.int32)
    pos = np.array([5, 2 * ps + 3, 0], np.int32)
    toks = rng.integers(0, cfg.vocab, B).astype(np.int32)
    return pools, pt, pos, toks


def _flash_inputs(seed=1):
    rng = np.random.default_rng(seed)
    B, hkv, grp, dh, T, ps = 3, 4, 4, 16, 3, 8
    N = 1 + B * T
    f32 = lambda *s: rng.normal(size=s).astype(np.float32)   # noqa: E731
    return dict(q=f32(B, hkv, grp, dh), pk=f32(N, ps, hkv, dh),
                pv=f32(N, ps, hkv, dh), kn=f32(B, hkv, dh),
                vn=f32(B, hkv, dh),
                pt=(1 + rng.permutation(N - 1)[:B * T].reshape(B, T)
                    ).astype(np.int32),
                pos=np.array([5, 2 * ps + 3, 0], np.int32))


def _prefill_inputs(vocab, bucket=32):
    rng = np.random.default_rng(bucket)
    lens = np.array([bucket // 2 + 1, bucket], np.int32)
    toks = np.zeros((2, bucket), np.int32)
    for i, n in enumerate(lens):
        toks[i, :n] = rng.integers(0, vocab, n)
    return toks, lens


def _moe_inputs(cfg, seed=2):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(2, 16, cfg.d_model)).astype(np.float32),
            rng.normal(size=(5, cfg.d_model)).astype(np.float32))


def _offsets(a, ctx):
    """This rank's in-page offsets of pool pages ``a`` (N, ps, …)."""
    return ctx.block(torch.from_numpy(a), (None, "kv_seq") +
                     (None,) * (a.ndim - 2)).clone()


def _serve(cfg, params, ctx=None, **kw):
    eng = teng.Engine(cfg, params, device="cpu", ctx=ctx, **ENGINE_KW, **kw)
    eng.tracker.f = lambda: PINNED_F
    reqs = [teng.Request(rid=i, prompt=p, max_new=MAX_NEW)
            for i, p in enumerate(_prompts(cfg.vocab))]
    eng.run(reqs)
    return [r.out for r in reqs]


def _collectives(ctx):
    """Each collective on this rank's inputs, and the refusals."""
    m, i = ctx.axis_size("model"), ctx.axis_index("model")
    x = torch.arange(24.0).reshape(2, 3, 4) + 100 * i
    res = {"gather0": coll.all_gather(x, 0, ctx),
           "gather1": coll.all_gather(x, 1, ctx),
           "gather_last": coll.all_gather(x, -1, ctx),
           "sum": coll.all_reduce(x, ctx),
           "max": coll.all_reduce(-x, ctx, op="max"),
           "x_kept": x.clone(),
           "bcast": coll.broadcast(torch.full((3,), float(i)), ctx),
           "coords": (ctx.axis_size("data"), m, i, ctx.coords)}
    try:
        coll.all_reduce(torch.empty(3, device="meta"), ctx)
    except ValueError as e:
        res["refused"] = str(e)
    return res


def _rank_cases(ctx, params_path, out_dir):
    """Every case on this rank; the results saved per rank."""
    m, i = ctx.axis_size("model"), ctx.axis_index("model")
    with open(params_path, "rb") as f:
        trees = pickle.load(f)
    res = {"collectives": _collectives(ctx)}
    fi = _flash_inputs()
    t = {k: torch.from_numpy(v) for k, v in fi.items()}
    pk, pv = _offsets(fi["pk"], ctx), _offsets(fi["pv"], ctx)
    o, pk, pv = tdec.flash_decode_gqa(
        t["q"], t["kn"], t["vn"], pk, pv, t["pos"], scale=0.25, softcap=0.0,
        page_table=t["pt"], ctx=ctx)
    res["flash"] = (o, pk, pv)
    for arch in ARCHS:
        cfg = tcfg(arch)
        params = params_from_numpy(trees[arch], cfg, "cpu", ctx=ctx)
        with torch.no_grad():
            toks, lens = _prefill_inputs(cfg.vocab)
            logits, cache = prefill(cfg, params, torch.from_numpy(toks),
                                    prompt_len=torch.from_numpy(lens),
                                    page_size=8, ctx=ctx)
            res[f"{arch}/prefill"] = (logits, cache["layers"])
            res[f"{arch}/hidden"] = lm_hidden(cfg, params,
                                              torch.from_numpy(toks), ctx=ctx)
            pools, pt, pos, toks = _decode_inputs(cfg)
            tcache = {"layers": [{n: _offsets(a, ctx) for n, a in l.items()}
                                 for l in pools]}
            logits, tcache = tdec.decode_step(
                cfg, params, tcache, torch.from_numpy(toks),
                torch.from_numpy(pos), torch.from_numpy(pt), ctx=ctx)
            res[f"{arch}/decode"] = (logits, tcache["layers"])
            if cfg.moe is not None:
                xb, xd = (torch.from_numpy(a) for a in _moe_inputs(cfg))
                p = params["layers"][0]["moe"]
                res[f"{arch}/moe"] = (moe_block(cfg, p, xb, ctx),
                                      moe_decode(cfg, p, xd, ctx))
        res[f"{arch}/streams"] = _serve(cfg, params, ctx)
    cfg = tcfg(ARCHS[0])
    res["sampled"] = _serve(cfg, params_from_numpy(
        trees[ARCHS[0]], cfg, "cpu", ctx=ctx), ctx, **SAMPLED)
    torch.save(res, os.path.join(out_dir, f"m{m}_r{i}.pt"))


class _SkewedClock:
    """rank 1's clock: every read lands ``step`` seconds later than the
    read before it would, so each interval rank 1 measures is longer than
    rank 0's by a different share, and its own ratio f differs."""

    def __init__(self, real, step):
        self.real, self.step, self.reads = real, step, 0

    def __call__(self):
        self.reads += 1
        return self.real() + self.step * self.reads


def _rank_skewed(ctx, params_path, out_dir):
    """The mistral engine, its admission ratio unpinned, with rank 1's
    clock skewed: every rank must admit the same groups."""
    i = ctx.axis_index("model")
    if i == 1:
        teng.time.perf_counter = _SkewedClock(time.perf_counter, 0.02)
    with open(params_path, "rb") as f:
        trees = pickle.load(f)
    cfg = tcfg(ARCHS[0])
    params = params_from_numpy(trees[ARCHS[0]], cfg, "cpu", ctx=ctx)
    eng = teng.Engine(cfg, params, device="cpu", ctx=ctx, **ENGINE_KW)
    reqs = [teng.Request(rid=k, prompt=p, max_new=MAX_NEW)
            for k, p in enumerate(_prompts(cfg.vocab) * 3)]
    for r in reqs:
        eng.submit(r)
    admitted, fs = [], []
    while eng.has_work():
        fs.append(eng.tracker.f())
        admitted.append(eng.step().admitted)
    torch.save({"admitted": admitted, "own_f": fs,
                "streams": [r.out for r in reqs]},
               os.path.join(out_dir, f"skew_r{i}.pt"))
