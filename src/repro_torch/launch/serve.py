"""Serving launcher (``repro/launch/serve.py``): the continuous-batching
engine on the smoke config of an arch, on the card.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch mistral-nemo-12b \
        --requests 8 --max-new 12 [--device cpu]
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.configs import get_config, smoke_config
from repro_torch.serve.engine import Request, make_engine


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mistral-nemo-12b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--max-slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=96)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="default: the CUDA device; 'cpu' runs on the host")
    args = ap.parse_args(argv)

    cfg = smoke_config(get_config(args.arch))
    eng = make_engine(cfg, seed=args.seed, device=args.device,
                      max_slots=args.max_slots, max_len=args.max_len)
    rng = np.random.default_rng(args.seed)
    reqs = [Request(rid=i,
                    prompt=rng.integers(0, cfg.vocab, rng.integers(4, 24))
                    .tolist(),
                    max_new=args.max_new)
            for i in range(args.requests)]
    t0 = time.perf_counter()
    eng.run(reqs)
    dt = time.perf_counter() - t0
    total = sum(len(r.out) for r in reqs)
    print(f"served {len(reqs)} requests, {total} tokens in {dt:.2f}s "
          f"({total / dt:.1f} tok/s), f={eng.tracker.f():.2f}")
    for r in reqs[:4]:
        print(f"  req {r.rid}: prompt[{len(r.prompt)}] -> {r.out}")


if __name__ == "__main__":
    main()
