"""Batched serving example (``examples/serve_batch.py``): continuous
batching with bucketed batched prefill, the decode quantum (one CUDA graph
replay a quantum on the card), HBB admission control, per-request streams.

    PYTHONPATH=src python -m repro_torch.examples.serve_batch \
        --arch h2o-danube-1.8b
    PYTHONPATH=src python -m repro_torch.examples.serve_batch \
        --arch mistral-nemo-12b --paged       # shared KV page pool
    PYTHONPATH=src python -m repro_torch.examples.serve_batch --smoke \
        --device cpu

The JAX example's ``--legacy`` per-token engine is not ported.
"""
import argparse
import time

import numpy as np

from repro_torch.configs import get_config, smoke_config
from repro_torch.serve.engine import Request, make_engine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="h2o-danube-1.8b")
    ap.add_argument("--requests", type=int, default=10)
    ap.add_argument("--max-new", type=int, default=10)
    ap.add_argument("--decode-quantum", type=int, default=8)
    ap.add_argument("--paged", action="store_true",
                    help="paged KV cache (shared page pool + per-slot "
                         "page table; full-attention layers)")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny fixed workload for CI smoke (fast, asserts "
                         "completion)")
    ap.add_argument("--device", default=None,
                    help="default: the CUDA device; 'cpu' runs on the host")
    args = ap.parse_args(argv)
    if args.smoke:
        args.requests, args.max_new = 4, 4

    cfg = smoke_config(get_config(args.arch))
    eng = make_engine(cfg, device=args.device, max_slots=4, max_len=96,
                      decode_quantum=args.decode_quantum, paged=args.paged,
                      page_size=8)
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i,
                    prompt=rng.integers(0, cfg.vocab,
                                        int(rng.integers(4, 32))).tolist(),
                    max_new=args.max_new)
            for i in range(args.requests)]
    t0 = time.perf_counter()
    eng.run(reqs)
    dt = time.perf_counter() - t0
    tok = sum(len(r.out) for r in reqs)
    print(f"{len(reqs)} requests / {tok} tokens in {dt:.2f}s "
          f"({tok / dt:.1f} tok/s incl. graph captures); admission f = "
          f"{eng.tracker.f():.2f}; {eng.prefill_groups} prefill groups for "
          f"{len({len(r.prompt) for r in reqs})} distinct prompt lengths; "
          f"{eng.decode_captures} decode graphs captured")
    if args.paged:
        al = eng.alloc
        print(f"  page pool: {al.usable_pages} usable pages × "
              f"{eng.page_size} tokens, {al.total_grants} grants")
    for r in reqs:
        print(f"  req {r.rid:2d} prompt[{len(r.prompt):2d}] → {r.out}")
    if args.smoke:
        assert all(r.done for r in reqs), "smoke: all requests must finish"
        print("smoke OK")


if __name__ == "__main__":
    main()
