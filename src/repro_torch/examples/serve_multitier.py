"""Multi-engine heterogeneous serving example (``examples/
serve_multitier.py``): the paper's CC/FC pool at request granularity.

Two tiers under one MultiEngine — a short-context dense tier (many small
slots) and a long-context paged tier (few expensive slots) — serve a mixed
workload of short prompts plus long prompts only the second tier can hold.
Requests are routed by the proportional_split law over measured per-tier
tok/s; a stalled or pool-exhausted tier's work reroutes instead of
blocking the queue. On the card the tiers step in parallel threads, each
on its own CUDA stream.

    PYTHONPATH=src python -m repro_torch.examples.serve_multitier
    PYTHONPATH=src python -m repro_torch.examples.serve_multitier --smoke \
        --device cpu                                  # CI-sized
    PYTHONPATH=src python -m repro_torch.examples.serve_multitier \
        --arch mistral-nemo-12b --requests 20 --long-requests 2
"""
import argparse
import time

import numpy as np

from repro_torch.configs import get_config, smoke_config
from repro_torch.serve.engine import Request, worst_case_pages
from repro_torch.serve.multi_engine import make_multi_engine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mistral-nemo-12b",
                    help="full-attention arch so the paged tier is used")
    ap.add_argument("--requests", type=int, default=12,
                    help="short requests (prompts 4-30 tokens)")
    ap.add_argument("--long-requests", type=int, default=2,
                    help="long requests (prompt 200 tokens) that only the "
                         "long-context tier can hold")
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--decode-quantum", type=int, default=8)
    ap.add_argument("--serial", action="store_true",
                    help="step tiers one after another instead of in "
                         "parallel threads")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny fixed workload for CI smoke (fast, asserts "
                         "completion)")
    ap.add_argument("--device", default=None,
                    help="default: the CUDA device; 'cpu' runs on the host")
    args = ap.parse_args(argv)
    if args.smoke:
        args.requests, args.long_requests, args.max_new = 4, 1, 4

    cfg = smoke_config(get_config(args.arch))
    short_len, long_len, page = 64, 512, 8
    long_prompt = 200
    long_slots = 2
    pages = max(1 + long_slots * worst_case_pages(
        long_prompt, args.max_new + 1, args.decode_quantum, long_len, page),
        1 + long_len // page)
    meng = make_multi_engine(cfg, [
        {"name": "short", "max_len": short_len, "max_slots": 4},
        {"name": "long", "max_len": long_len, "max_slots": long_slots,
         "paged": True, "page_size": page, "num_pages": pages},
    ], device=args.device, decode_quantum=args.decode_quantum,
        concurrent=not args.serial)

    rng = np.random.default_rng(0)
    reqs = [Request(rid=i,
                    prompt=rng.integers(0, cfg.vocab,
                                        int(rng.integers(4, 31))).tolist(),
                    max_new=args.max_new)
            for i in range(args.requests)]
    reqs += [Request(rid=100 + i,
                     prompt=rng.integers(0, cfg.vocab, long_prompt).tolist(),
                     max_new=args.max_new)
             for i in range(args.long_requests)]
    t0 = time.perf_counter()
    meng.run(reqs)
    dt = time.perf_counter() - t0
    tok = sum(len(r.out) for r in reqs)
    print(f"{len(reqs)} requests / {tok} tokens in {dt:.2f}s "
          f"({tok / dt:.1f} tok/s incl. graph captures) across "
          f"{len(meng.tiers)} tiers, {meng.cycles} pool cycles")
    for name, t in meng.stats()["tiers"].items():
        print(f"  tier {name:6s}: {t['routed']:3d} requests routed, "
              f"{t['decoded']:4d} tokens decoded, "
              f"{t['tok_s']:.1f} tok/s measured")
    for r in reqs:
        tier = meng.assigned[r.rid]
        print(f"  req {r.rid:3d} prompt[{len(r.prompt):3d}] via {tier:6s} "
              f"→ {r.out[:8]}{'…' if len(r.out) > 8 else ''}")
    if args.smoke:
        assert all(r.done for r in reqs), "smoke: all requests must finish"
        assert all(meng.assigned[r.rid] == "long"
                   for r in reqs if len(r.prompt) >= short_len), \
            "smoke: long prompts must land on the long tier"
        print("smoke OK")


if __name__ == "__main__":
    main()
