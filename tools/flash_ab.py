#!/usr/bin/env python3
"""Hold the flash kernels of several trees of the port against each other
on the card.

    python3 tools/flash_ab.py TREE [TREE ...] [--phases]

Each TREE (a checkout, or a ``git archive`` of one: ``chip_smoke.py`` and
``src/repro_torch``) runs in a process of its own, in the order given
(parent, change, change, parent). Each prints the card's name and power
limit, then:

- the SHA-256 of o, lse, dq, dk and dv of the bf16 flash training pair at
  the shapes of the dh-64 and dh-128 ``mma`` backward (mistral-nemo-12b's
  B 4, T 2048, 32 heads over 8, causal and window 256 + softcap 30;
  whisper-large-v3's encoder, decoder self and cross attention; internvl2's
  G 6), each with its route and the backward's CUDA-event ms;
- deepseek-v2's MLA backward at (192, 128) (B 4, T 2048, H 128) and
  h2o-danube-1.8b's dh-80 forward (B 2, T 4096, 32 heads over 8, window
  4096), their routes and CUDA-event ms;
- one profiled prefill of danube's longest prompt of ``chip_smoke.py``'s
  workload (5716 tokens, 24 layers): wall and busy ms, the flash forward's
  device ms and launches;
- for each prompt of that workload, danube's last-token prefill logits
  (bf16) against the same weights upcast to f32 (the f32 route): the
  largest error relative to the largest logit, whether the argmax agrees,
  and the f32 logits' top-2 margin.

With ``--phases`` the first run of each tree also runs that tree's
``chip_smoke.py`` phases ``deepseek_phase``, ``danube_phase`` and
``train_mla_phase`` (a digest of each served workload's greedy streams, the
train-mla losses of steps 1-5 and the step time). A last table sets the
trees side by side, with the first token where the first two trees'
streams part. Exits 1 if a tree's process or one of its checks failed.
"""
from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

# name, B, Tq, Tk, H, Hk, dh, causal, window, softcap
BWD_SHAPES = (
    ("mistral dh128 causal", 4, 2048, 2048, 32, 8, 128, True, 0, 0.0),
    ("mistral dh128 window 256 softcap 30", 4, 2048, 2048, 32, 8, 128, True,
     256, 30.0),
    ("whisper encoder", 8, 1500, 1500, 20, 20, 64, False, 0, 0.0),
    ("whisper decoder self", 8, 448, 448, 20, 20, 64, True, 0, 0.0),
    ("whisper cross", 8, 448, 1500, 20, 20, 64, False, 0, 0.0),
    ("internvl2 G6", 4, 2048, 2048, 48, 8, 128, True, 0, 0.0))


def _digest(*ts) -> str:
    import torch
    h = hashlib.sha256()
    for t in ts:
        t = t.detach().contiguous().cpu()
        h.update((t.view(torch.int16) if t.dtype == torch.bfloat16
                  else t).numpy().tobytes())
    return h.hexdigest()[:16]


class _AllPaths(list):
    def __contains__(self, item):
        return True


def one(tree: Path, phases: bool) -> int:
    sys.path[:0] = [str(tree), str(tree / "src")]
    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.params import tree_map
    from repro_torch.serve.prefill import prefill
    if not torch.cuda.is_available():
        print("flash_ab: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    cs.CARD = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, check=True).stdout.strip()
    print(cs.CARD)
    print(f"repro_torch from {Path(ops.__file__).parents[2]}")
    print(f"kernels built in {_build.build():.1f} s", flush=True)
    dev = torch.device("cuda")
    dt = torch.bfloat16
    res = {"tree": str(tree), "bwd": {}, "streams": {}}

    def randn(*shape, g):
        return torch.randn(shape, generator=g, device=dev).to(dt)

    for name, B, Tq, Tk, H, Hk, dh, causal, window, softcap in BWD_SHAPES:
        g = torch.Generator(device=dev).manual_seed(Tq + Tk + H + window)
        q, do = (randn(B, Tq, H, dh, g=g).permute(0, 2, 1, 3)
                 for _ in range(2))
        k, v = (randn(B, Tk, Hk, dh, g=g).permute(0, 2, 1, 3)
                for _ in range(2))
        kw = dict(scale=dh ** -0.5, causal=causal, window=window,
                  softcap=softcap)
        route = ops.bwd_route(dt, dh, dh, ops._aligned(q, k, v, do))
        o, lse = ops.attend_fwd_lse(q, k, v, **kw)
        got = ops.attend_bwd(q, k, v, o, lse, do, **kw)
        ms = cs.time_ms(lambda: ops.attend_bwd(q, k, v, o, lse, do, **kw),
                        10)
        res["bwd"][name] = {"route": route, "sha256": _digest(o, lse, *got),
                            "ms": ms}
        print(f"bwd {name} (B={B} Tq={Tq} Tk={Tk} H={H} Hkv={Hk} dh={dh}): "
              f"route {route}, sha256(o, lse, dq, dk, dv) "
              f"{res['bwd'][name]['sha256']}, {ms:.4f} ms", flush=True)
        del q, do, k, v, o, lse, got
        torch.cuda.empty_cache()

    g = torch.Generator(device=dev).manual_seed(11)
    B, T, H = 4, 2048, 128
    q, k = (randn(B, T, H, 192, g=g).permute(0, 2, 1, 3) for _ in range(2))
    v = randn(B, T, H, 256, g=g)[..., 128:].permute(0, 2, 1, 3)
    do = randn(B, T, H, 128, g=g).permute(0, 2, 1, 3)
    kw = dict(scale=192 ** -0.5, causal=True)
    o, lse = ops.attend_fwd_lse(q, k, v, **kw)
    route = ops.bwd_route(dt, 192, 128, ops._aligned(q, k, v, do))
    ms = cs.time_ms(lambda: ops.attend_bwd(q, k, v, o, lse, do, **kw), 3, 1)
    res["mla_bwd"] = {"route": route, "ms": ms}
    print(f"bwd MLA (B={B} T={T} H={H} (192, 128) causal): route {route}, "
          f"{ms:.4f} ms", flush=True)
    del q, k, v, do, o, lse
    torch.cuda.empty_cache()

    g = torch.Generator(device=dev).manual_seed(80)
    q = randn(2, 4096, 32, 80, g=g).permute(0, 2, 1, 3)
    k, v = (randn(2, 4096, 8, 80, g=g).permute(0, 2, 1, 3) for _ in range(2))
    kw = dict(scale=80 ** -0.5, causal=True, window=4096)
    route = ops.fwd_route(dt, 80, 80, ops._aligned(q, k, v))
    ms = cs.time_ms(lambda: ops.attend(q, k, v, **kw), 10)
    res["fwd80"] = {"route": route, "ms": ms}
    print(f"fwd dh80 (B=2 T=4096 H=32 Hkv=8 window 4096): route {route}, "
          f"{ms:.4f} ms", flush=True)
    del q, k, v
    torch.cuda.empty_cache()

    cfg = get_config("h2o-danube-1.8b")
    params = cs._make_params(cfg, dev)
    lens, prompts = cs._long_workload(cfg.vocab)
    prompt = prompts[int(np.argmax(lens))]
    toks = torch.tensor([prompt], dtype=torch.int32, device=dev)
    pl = torch.tensor([len(prompt)], dtype=torch.int32, device=dev)

    def run():
        return prefill(cfg, params, toks, prompt_len=pl, page_size=16)

    run()
    torch.cuda.synchronize()
    n0 = ops.launches
    with cs.device_profile(cpu=True) as prof:
        t = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    busy, n, by_name = cs.device_time(prof)
    flash = sum(us for name, (us, _) in by_name.items() if "flash_fwd" in name)
    res["danube_prefill"] = {"wall_ms": wall * 1e3, "busy_ms": busy / 1e3,
                             "flash_ms": flash / 1e3,
                             "flash_launches": ops.launches - n0}
    print(f"profile: one {cfg.name} prefill group (1 x {len(prompt)} tokens, "
          f"profiler on): wall {wall * 1e3:.1f} ms, device busy "
          f"{busy / 1e3:.3f} ms, {n} kernels; flash forward "
          f"{flash / 1e3:.3f} ms device over {ops.launches - n0} launches",
          flush=True)
    cs.print_top(by_name, 8)

    cfg32 = dataclasses.replace(cfg, param_dtype="float32")
    params32 = tree_map(lambda x: x.float() if x.is_floating_point() else x,
                        params)
    res["danube_logits"] = []
    for p in prompts:
        toks = torch.tensor([p], dtype=torch.int32, device=dev)
        pl = torch.tensor([len(p)], dtype=torch.int32, device=dev)
        got = prefill(cfg, params, toks, prompt_len=pl, page_size=16)[0]
        want = prefill(cfg32, params32, toks, prompt_len=pl, page_size=16)[0]
        top2 = want.topk(2).values[0]
        res["danube_logits"].append({
            "len": len(p), "rel": float((got.float() - want).abs().max()
                                        / want.abs().max()),
            "argmax_equal": bool(got.argmax() == want.argmax()),
            "f32_margin": float(top2[0] - top2[1])})
        print(f"danube prefill logits, prompt of {len(p)}: bf16 against f32 "
              f"{res['danube_logits'][-1]}", flush=True)
    del params, params32
    torch.cuda.empty_cache()

    if phases:
        serve_twice = cs.serve_twice

        def recording(eng, cfg, *a, **kw):
            streams = serve_twice(eng, cfg, *a, **kw)
            res["streams"][cfg.name] = hashlib.sha256(
                json.dumps(streams).encode()).hexdigest()[:16]
            res.setdefault("stream_lists", {})[cfg.name] = streams
            print(f"streams {cfg.name}: sha256 {res['streams'][cfg.name]}, "
                  f"request 0 {streams[0][:12]}", flush=True)
            return streams

        cs.serve_twice = recording
        entries = [{"name": name, "paths": _AllPaths()}
                   for name in cs._counters()]
        for phase in (cs.deepseek_phase, cs.danube_phase, cs.train_mla_phase):
            t = time.perf_counter()
            phase(dev, entries)
            print(f"phase {phase.__name__}: {time.perf_counter() - t:.1f} s",
                  flush=True)
        res["failures"] = list(cs.FAILURES)
    print("AB " + json.dumps(res), flush=True)
    return 1 if cs.FAILURES else 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="+")
    ap.add_argument("--phases", action="store_true",
                    help="also run deepseek_phase, danube_phase and "
                         "train_mla_phase in each tree's first run")
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        return one(Path(args.trees[0]).resolve(), args.phases)
    runs, seen, rc = [], set(), 0
    for tree in args.trees:
        cmd = [sys.executable, os.path.abspath(__file__), "--one", tree]
        if args.phases and tree not in seen:
            cmd.append("--phases")
        seen.add(tree)
        print(f"=== {tree}{' (phases)' if '--phases' in cmd else ''}",
              flush=True)
        p = subprocess.run(cmd, stdout=subprocess.PIPE,
                           stderr=subprocess.STDOUT, text=True)
        print(p.stdout, flush=True)
        rc |= p.returncode
        res = next((json.loads(line[3:]) for line in p.stdout.splitlines()
                    if line.startswith("AB ")), None)
        if res is None:
            print(f"=== {tree}: no result (exit {p.returncode})")
            continue
        m = re.search(r"\(train-mla\)[^\n]*\n((?:  step .*\n)+)", p.stdout)
        res["train_mla_losses"] = re.findall(r"loss ([\d.]+)", m.group(1)) \
            if m else []
        m = re.search(r"train train-mla: .*steps 2-5 mean ([\d.]+) s",
                      p.stdout)
        res["train_mla_step_s"] = m.group(1) if m else None
        runs.append(res)
    print("=== side by side (trees in run order)")
    for name, *_ in BWD_SHAPES:
        row = [r["bwd"][name] for r in runs]
        same = len({x["sha256"] for x in row}) == 1
        print(f"bwd {name}: bit-equal across runs {same}; routes "
              f"{[x['route'] for x in row]}; ms "
              f"{[round(x['ms'], 4) for x in row]}")
    print(f"bwd MLA: routes {[r['mla_bwd']['route'] for r in runs]}, ms "
          f"{[round(r['mla_bwd']['ms'], 4) for r in runs]}")
    print(f"fwd dh80: routes {[r['fwd80']['route'] for r in runs]}, ms "
          f"{[round(r['fwd80']['ms'], 4) for r in runs]}")
    print("danube prefill (busy ms, flash ms, flash launches): "
          f"{[(round(r['danube_prefill']['busy_ms'], 3), round(r['danube_prefill']['flash_ms'], 3), r['danube_prefill']['flash_launches']) for r in runs]}")
    with_phases = [r for r in runs if r["streams"]]
    print("danube prefill logits, bf16 against f32, per prompt (rel error, "
          "argmax equal): " + "; ".join(
              str([(round(x["rel"], 5), x["argmax_equal"])
                   for x in r["danube_logits"]]) for r in runs))
    for name in sorted({n for r in with_phases for n in r["streams"]}):
        print(f"streams {name}: {[r['streams'].get(name) for r in with_phases]}"
              f", equal {len({r['streams'].get(name) for r in with_phases}) == 1}")
        lists = [r["stream_lists"][name] for r in with_phases]
        parts = [next((i for i, (a, b) in enumerate(zip(x, y)) if a != b),
                      None) for x, y in zip(*lists[:2])]
        print(f"streams {name}: first token where the first two trees part, "
              f"per request: {parts}")
    for r in with_phases:
        print(f"train-mla {r['tree']}: losses {r['train_mla_losses']}, steps "
              f"2-5 mean {r['train_mla_step_s']} s, failed checks "
              f"{r.get('failures')}")
    return 1 if rc else 0


if __name__ == "__main__":
    sys.exit(main())
