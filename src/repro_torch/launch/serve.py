"""Serving launcher (``repro/launch/serve.py``): the continuous-batching
engine on the smoke config of an arch, on the card.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch mistral-nemo-12b \
        --requests 8 --max-new 12 [--device cpu]

``--model-parallel N`` serves across N ranks of the ``model`` axis (the
paged engine, each rank holding its blocks of the weights and its offsets
of the page pools; rank 0 prints). Under ``torchrun`` each process is one
rank:

    torchrun --nproc-per-node N -m repro_torch.launch.serve --model-parallel N

without it the launcher spawns the N ranks itself (NCCL, one card each;
gloo ranks on the host with ``--device cpu``).
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch.distributed as dist

from repro_torch.configs import get_config, smoke_config
from repro_torch.launch.mesh import make_ctx, spawn_ranks
from repro_torch.serve.engine import Request, make_engine


def _serve(ctx, args) -> None:
    """Serve the seeded workload on this rank (every rank alike)."""
    cfg = smoke_config(get_config(args.arch))
    kw = {} if ctx is None else {"paged": True}
    eng = make_engine(cfg, seed=args.seed, device=args.device, ctx=ctx,
                      max_slots=args.max_slots, max_len=args.max_len, **kw)
    rng = np.random.default_rng(args.seed)
    reqs = [Request(rid=i,
                    prompt=rng.integers(0, cfg.vocab, rng.integers(4, 24))
                    .tolist(),
                    max_new=args.max_new)
            for i in range(args.requests)]
    t0 = time.perf_counter()
    eng.run(reqs)
    dt = time.perf_counter() - t0
    if eng.rank:
        return
    total = sum(len(r.out) for r in reqs)
    where = "" if ctx is None else f" over {eng.msize} ranks"
    print(f"served {len(reqs)} requests, {total} tokens in {dt:.2f}s "
          f"({total / dt:.1f} tok/s){where}, f={eng.tracker.f():.2f}")
    for r in reqs[:4]:
        print(f"  req {r.rid}: prompt[{len(r.prompt)}] -> {r.out}")


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
    ap.add_argument("--model-parallel", type=int, default=1,
                    help="ranks on the model axis (torchrun's processes, "
                         "or spawned here)")
    args = ap.parse_args(argv)
    if args.model_parallel == 1:
        _serve(None, args)
        return
    device_type = "cpu" if args.device == "cpu" else "cuda"
    if "WORLD_SIZE" not in os.environ:
        spawn_ranks(_serve, args.model_parallel, args,
                    device_type=device_type)
        return
    ctx = make_ctx(1, args.model_parallel, device_type=device_type)
    try:
        _serve(ctx, args)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
