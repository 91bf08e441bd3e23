#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

1. Requires a CUDA device; prints the card's name and power limit.
2. Builds the hand-written kernels from this checkout (nvcc, sm_90a).
3. Holds each kernel against its plain PyTorch version at the main path's
   shapes in bf16, and times kernel, plain version and (flash) PyTorch's
   scaled_dot_product_attention with CUDA events.
4. Serves full-width mistral-nemo-12b (seeded random weights made on the
   card) through the paged engine, twice, and checks that every request
   finishes with in-vocabulary tokens, the page pool is whole, both kernels
   were launched, and the two runs give the same streams.
5. Profiles one decode quantum (device busy share, kernels by time).
6. Checks prefill → decode against a one-token-longer prefill at full width
   (f32, depth cut to 2 layers; the bf16 40-layer error is reported).
7. Prints one JSON line {"kernels": [...]}, then as the last line
   {"ok": true, "device": {...}}. Any failed check exits non-zero without it.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

HBM_BYTES_PER_S = 3.35e12                      # H100 SXM data sheet
PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.float32: 67e12}
BF16_TOL = 3e-2          # as tests/test_kernels.py for bf16
FAILURES: list[str] = []


def check(ok: bool, what: str) -> None:
    print(("ok    " if ok else "FAIL  ") + what, flush=True)
    if not ok:
        FAILURES.append(what)


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(n_bytes: float, n_ops: float, dtype) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = n_ops / PEAK_OPS_PER_S[dtype]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


# ------------------------------------------------------------ paged decode
def paged_phase(dev) -> dict:
    from repro_torch.kernels.paged_attention import ops, ref
    B, hkv, grp, dh, ps, max_len = 8, 8, 4, 128, 16, 4096
    T = max_len // ps
    N = 1 + B * T
    rng = np.random.default_rng(0)
    dt = torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(0)
    q = torch.randn((B, hkv, grp, dh), generator=g, device=dev).to(dt)
    pk = torch.randn((N, ps, hkv, dh), generator=g, device=dev).to(dt)
    pv = torch.randn((N, ps, hkv, dh), generator=g, device=dev).to(dt)
    table = torch.tensor(1 + rng.permutation(N - 1).reshape(B, T),
                         dtype=torch.int32, device=dev)
    pos_h = np.concatenate([[max_len - 1, 0, ps - 1, ps],
                            rng.integers(1, max_len, B - 4)])
    pos = torch.tensor(pos_h, dtype=torch.int32, device=dev)
    scale = dh ** -0.5
    err = 0.0
    for softcap in (0.0, 30.0):
        o, m, l = ops.paged_attend_gqa(q, pk, pv, table, pos, 0,
                                       page_size=ps, scale=scale,
                                       softcap=softcap)
        o_r, m_r, l_r = ref.paged_flash_decode_gqa_ref(
            q, pk, pv, table, pos, 0, page_size=ps, scale=scale,
            softcap=softcap)
        e = float((o / l[..., None] - o_r / l_r[..., None]).abs().max())
        e_m = float((m - m_r).abs().max())
        e_l = float(((l - l_r).abs() / l_r).max())
        err = max(err, e)
        check(e <= 1e-3 and e_m <= 1e-3 and e_l <= 1e-3,
              f"paged decode softcap={softcap}: |o/l - ref| {e:.3g}, "
              f"|m - ref| {e_m:.3g}, rel |l - ref| {e_l:.3g} (tol 1e-3)")
    keys = int((pos_h + 1).sum())               # positions ≤ pos per slot
    n_bytes = (q.numel() * 2 + 2 * keys * hkv * dh * 2
               + 4 * int(sum(-(-(p + 1) // ps) for p in pos_h)) + 4 * B
               + B * hkv * grp * (dh + 2) * 4)
    n_ops = 4 * keys * hkv * grp * dh
    b_ms, b_by = bound_ms(n_bytes, n_ops, dt)
    ms = time_ms(lambda: ops.paged_attend_gqa(
        q, pk, pv, table, pos, 0, page_size=ps, scale=scale), 50, 5)
    plain = time_ms(lambda: ref.paged_flash_decode_gqa_ref(
        q, pk, pv, table, pos, 0, page_size=ps, scale=scale), 10)
    print(f"paged decode B={B} Hkv={hkv} G={grp} dh={dh} ps={ps} "
          f"pos={pos_h.tolist()}: kernel {ms:.4f} ms, plain {plain:.4f} ms, "
          f"bound {b_ms:.4f} ms ({b_by}), {n_bytes / ms / 1e6:.1f} GB/s")
    return {"name": "paged_attention_gqa", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
            "replaces": "src/repro/kernels/paged_attention/"
                        "paged_attention.py:161",
            "max_abs_err": err, "tol": 1e-3, "ms": ms, "plain_ms": plain,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "check": "o/l, m, l against paged_flash_decode_gqa_ref, bf16 "
                     "pools, mixed pos up to 4095, softcap 0 and 30"}


# ------------------------------------------------------------ flash prefill
def flash_phase(dev) -> dict:
    from repro_torch.kernels.flash_attention import ops, ref
    B, H, Hk, dh = 8, 32, 8, 128
    dt = torch.bfloat16
    scale = dh ** -0.5
    err, main = 0.0, None
    for T, causal, window, softcap in ((1024, True, 0, 0.0),
                                       (2048, True, 0, 0.0),
                                       (1024, True, 256, 30.0),
                                       (1000, True, 0, 0.0)):
        g = torch.Generator(device=dev).manual_seed(T + window)
        # the prefill's layout: (B, T, heads, dh) memory, head-major views
        q = torch.randn((B, T, H, dh), generator=g, device=dev).to(dt)
        k = torch.randn((B, T, Hk, dh), generator=g, device=dev).to(dt)
        v = torch.randn((B, T, Hk, dh), generator=g, device=dev).to(dt)
        qv, kv, vv = (x.permute(0, 2, 1, 3) for x in (q, k, v))
        kw = dict(scale=scale, causal=causal, window=window, softcap=softcap)
        out = ops.attend(qv, kv, vv, **kw)
        want = ref.flash_attention_ref(qv, kv, vv, **kw)
        e = float((out.float() - want.float()).abs().max())
        err = max(err, e)
        check(e <= BF16_TOL, f"flash T={T} causal={causal} window={window} "
              f"softcap={softcap}: max |out - ref| {e:.3g} "
              f"(tol {BF16_TOL})")
        del want
        rows = np.arange(T)
        lo = np.maximum(0, rows - window + 1) if window else np.zeros(T)
        hi = rows if causal else np.full(T, T - 1)
        pairs = int((hi - lo + 1).sum())
        n_ops = 4 * dh * pairs * B * H
        n_bytes = 2 * B * T * (2 * H + 2 * Hk) * dh
        b_ms, b_by = bound_ms(n_bytes, n_ops, dt)
        ms = time_ms(lambda: ops.attend(qv, kv, vv, **kw), 10)
        plain = time_ms(lambda: ref.flash_attention_ref(qv, kv, vv, **kw), 2,
                        1)
        lib = None
        if not window and not softcap:
            qc, kc, vc = qv.contiguous(), kv.contiguous(), vv.contiguous()
            lib = time_ms(lambda: F.scaled_dot_product_attention(
                qc, kc, vc, is_causal=causal, scale=scale, enable_gqa=True),
                10)
        print(f"flash B={B} H={H} Hkv={Hk} T={T} window={window} "
              f"softcap={softcap}: kernel {ms:.4f} ms, plain {plain:.4f} ms, "
              f"sdpa {lib if lib is None else round(lib, 4)} ms, bound "
              f"{b_ms:.4f} ms ({b_by}), {n_ops / ms / 1e9:.2f} TFLOP/s")
        if main is None:
            main = (ms, plain, b_ms, b_by, lib)
        torch.cuda.empty_cache()
    ms, plain, b_ms, b_by, lib = main
    return {"name": "flash_attention_fwd", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention/"
                        "flash_attention.py:92",
            "max_abs_err": err, "tol": BF16_TOL, "ms": ms, "plain_ms": plain,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib,
            "check": "out against flash_attention_ref, bf16, B=8 H=32 Hkv=8 "
                     "dh=128: T=1024/2048 causal, window 256 + softcap 30, "
                     "ragged T=1000; times at T=1024 causal"}


# ------------------------------------------------------- full-width serving
def serve_phase(dev, entries) -> None:
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.paged_attention import ops as paged_ops
    from repro_torch.params import init_params, n_params
    from repro_torch.serve.engine import Engine, Request

    cfg = get_config("mistral-nemo-12b")
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    print(f"{cfg.name}: {n_params(cfg) / 1e9:.3f} B params made on the card "
          f"in {time.perf_counter() - t0:.1f} s")
    eng = Engine(cfg, params, device=dev, max_slots=8, max_len=4096,
                 page_size=16, decode_quantum=8)
    rng = np.random.default_rng(0)
    lens = rng.integers(16, 2001, 12)
    prompts = [rng.integers(0, cfg.vocab, n).tolist() for n in lens]
    max_new = 32

    def serve():
        reqs = [Request(rid=i, prompt=p, max_new=max_new)
                for i, p in enumerate(prompts)]
        flash_ops.launches = 0
        paged_ops.launches = 0
        torch.cuda.reset_peak_memory_stats()
        pre0 = eng.tracker.stats["prefill"].busy_time
        dec0 = eng.tracker.stats["decode"].busy_time
        q0, g0 = eng.quanta, eng.prefill_groups
        t = time.perf_counter()
        eng.run(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        launches = {"flash_attention_fwd": flash_ops.launches,
                    "paged_attention_gqa": paged_ops.launches}
        pre = eng.tracker.stats["prefill"].busy_time - pre0
        dec = eng.tracker.stats["decode"].busy_time - dec0
        emitted = sum(len(r.out) - 1 for r in reqs)  # first token: prefill
        print(f"serve: {len(reqs)} requests, prompt lengths {lens.tolist()},"
              f" max_new {max_new}: wall {wall:.3f} s, prefill "
              f"{pre:.3f} s over {eng.prefill_groups - g0} groups "
              f"({int(lens.sum()) / pre:.1f} prompt tok/s), decode "
              f"{dec:.3f} s over {eng.quanta - q0} quanta "
              f"({emitted / dec:.1f} tok/s), peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
              f"launches {launches}")
        return reqs, launches

    reqs, launches = serve()
    check(all(r.done and len(r.out) == max_new for r in reqs),
          "every request finished with max_new tokens")
    check(all(0 <= t < cfg.vocab for r in reqs for t in r.out),
          "every token is in the vocabulary")
    eng.alloc.check()
    check(len(eng.alloc.free) == eng.alloc.usable_pages,
          "page pool whole and every page free after the run")
    for e in entries:
        e["launches"] = launches[e["name"]]
        check(e["launches"] > 0, f"{e['name']} launched on the main path "
              f"({e['launches']} times)")
    again, _ = serve()
    check([r.out for r in again] == [r.out for r in reqs],
          "a second run of the workload gives the same streams")
    profile_phase(eng, cfg)
    rel = prefill_decode_rel(cfg, params, dev)
    print(f"full width bf16, 40 layers: prefill(S) + paged decode vs "
          f"prefill(S+1), relative max error {rel:.3g} (reported, not held:"
          f" bf16 rounding through 40 random layers)")
    del eng, params
    torch.cuda.empty_cache()
    cfg32 = dataclasses.replace(cfg, n_layers=2, param_dtype="float32")
    rel = prefill_decode_rel(cfg32, init_params(cfg32, seed=0, device=dev),
                             dev)
    check(rel < 1e-3, f"full width f32, depth cut to 2 layers: prefill(S) + "
          f"paged decode ≡ prefill(S+1), relative max error {rel:.3g} "
          f"(tol 1e-3)")


def profile_phase(eng, cfg) -> None:
    """One decode quantum of 8 full slots at ~1k context under
    torch.profiler (admission done before): device busy share of the wall
    time and the kernels by device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serve.engine import Request
    rng = np.random.default_rng(1)
    for i in range(eng.max_slots):
        eng.submit(Request(rid=100 + i, max_new=64,
                           prompt=rng.integers(0, cfg.vocab, 1024).tolist()))
    while eng.pending:                          # admit every request first
        eng.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        rep = eng.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    eng.drain()
    # device activity only; "Command Buffer Full" marks a full launch queue
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA
               and "Command Buffer Full" not in e.name]
    busy, end = 0.0, float("-inf")
    for a, b in sorted((e.time_range.start, e.time_range.end)
                       for e in kernels):
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    by_name: dict[str, list] = {}
    for e in kernels:
        acc = by_name.setdefault(e.name, [0.0, 0])
        acc[0] += e.time_range.end - e.time_range.start
        acc[1] += 1
    print(f"profile: one decode quantum ({rep.decoded} tokens, "
          f"{eng.decode_quantum} steps, 8 slots at ~1k context, profiler "
          f"on): wall {wall * 1e3:.1f} ms, device busy {busy / 1e3:.1f} ms "
          f"({busy / 1e4 / wall:.1f} %), {len(kernels)} kernels")
    for name, (us, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[
            :12]:
        print(f"  {us / 1e3:9.3f} ms {n:6d}x  {name[:90]}")


def prefill_decode_rel(cfg, params, dev) -> float:
    """prefill(S) + paged decode of token S against the last logits of
    prefill(S + 1): the relative max error (tests/test_serve.py's check)."""
    from repro_torch.serve.decode import decode_step
    from repro_torch.serve.prefill import prefill
    S, ps = 100, 16
    g = torch.Generator(device=dev).manual_seed(1)
    toks = torch.randint(0, cfg.vocab, (1, S + 1), generator=g, device=dev,
                         dtype=torch.int32)
    ref, _ = prefill(cfg, params, toks)
    _, rows = prefill(cfg, params, toks[:, :S], page_size=ps)
    n_rows = -(-S // ps)
    T = -(-(S + 1) // ps)
    pools = []
    for layer in rows["layers"]:
        pool = {}
        for name, r in layer.items():
            p = r.new_zeros((1 + T, ps) + tuple(r.shape[2:]))
            p[1:1 + n_rows] = r[0].reshape((n_rows, ps) + tuple(r.shape[2:]))
            pool[name] = p
        pools.append(pool)
    table = torch.arange(1, 1 + T, dtype=torch.int32, device=dev)[None]
    pos = torch.tensor([S], dtype=torch.int32, device=dev)
    got, _ = decode_step(cfg, params, {"layers": pools}, toks[:, S], pos,
                         table)
    check(bool(torch.isfinite(got).all()), "decode logits are finite")
    return float((got - ref).abs().max() / ref.abs().max())


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    built = _build.build()
    print(f"kernels built in {built:.1f} s")
    for name in _build.NAMES:
        log = _build.library_path(name).with_suffix(".log")
        if log.exists():
            for line in log.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    print(f"  {name}: {line.strip()}")
    entries = [paged_phase(dev), flash_phase(dev)]
    torch.cuda.empty_cache()
    serve_phase(dev, entries)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "tol", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "check")
    print(json.dumps({"kernels": [{k: e[k] for k in keys} for e in entries]}))
    print(smi)
    print(f"total {time.perf_counter() - t0:.1f} s")
    if FAILURES:
        print(f"{len(FAILURES)} check(s) failed: {FAILURES}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
