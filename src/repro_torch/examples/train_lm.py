"""End-to-end training driver (``examples/train_lm.py``): train a small LM
for a few hundred steps on the synthetic copy-structured stream and watch it
learn (the loss drops below the unigram entropy once it exploits the copy
pattern).

    PYTHONPATH=src python -m repro_torch.examples.train_lm          # ~2M params
    PYTHONPATH=src python -m repro_torch.examples.train_lm --hundred-m
    PYTHONPATH=src python -m repro_torch.examples.train_lm --steps 10 \
        --device cpu --inject-failure

Exercises the training substrate: the data pipeline with prefetch, AdamW
(f32 or int8 moments), checkpoint and restart (stop it mid-run and run it
again with the same ``--ckpt-dir``: it resumes) and, with
``--inject-failure``, a simulated failure at half the steps that the loop
recovers from by restoring the newest checkpoint.
"""
import argparse
import dataclasses
import os
import tempfile

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.data.loader import PrefetchLoader
from repro_torch.data.synthetic import SyntheticLM
from repro_torch.train.elastic import FailureInjector
from repro_torch.train.loop import LoopConfig, train_loop
from repro_torch.train.optimizer import OptConfig

MINI = ModelConfig(
    name="lm-mini", family="dense", n_layers=4, d_model=128, n_heads=4,
    n_kv_heads=2, head_dim=32, d_ff=384, vocab=2048, act="swiglu",
    attn_chunk=64)

HUNDRED_M = dataclasses.replace(
    MINI, name="lm-100m", n_layers=12, d_model=768, n_heads=12, n_kv_heads=4,
    head_dim=64, d_ff=2304, vocab=32_000)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--hundred-m", action="store_true")
    ap.add_argument("--inject-failure", action="store_true")
    ap.add_argument("--moments", choices=["float32", "int8"],
                    default="float32")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_lm"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--device", default=None,
                    help="default: the CUDA device; 'cpu' runs on the host")
    args = ap.parse_args(argv)

    cfg = HUNDRED_M if args.hundred_m else MINI
    data = SyntheticLM(cfg.vocab, args.seq, seed=0)
    loader = PrefetchLoader(data.iterator(args.batch), args.device)
    ocfg = OptConfig(lr=3e-3, warmup_steps=args.steps // 10,
                     decay_steps=args.steps, moments_dtype=args.moments)
    lcfg = LoopConfig(total_steps=args.steps, ckpt_every=args.ckpt_every,
                      ckpt_dir=args.ckpt_dir)
    inj = FailureInjector({args.steps // 2: RuntimeError("injected")}) \
        if args.inject_failure else None

    losses = []

    def log(step, row):
        losses.append(row["loss"])
        if step % 20 == 0:
            print(f"step {step:4d}  loss {row['loss']:.4f}  "
                  f"{row['tokens'] / row['dt']:.0f} tok/s")

    try:
        res = train_loop(cfg, ocfg, lcfg, iter(loader), on_step=log,
                         failure_injector=inj, device=args.device)
    finally:
        loader.close()
    uni = np.log(cfg.vocab) * 0.75  # rough unigram entropy of the zipf mix
    print(f"\nfirst-5 loss {np.mean(losses[:5]):.3f} → "
          f"last-5 {np.mean(losses[-5:]):.3f} "
          f"(unigram ≈ {uni:.2f}); restarts={res.restarts} "
          f"resumed_from={res.resumed_from}")


if __name__ == "__main__":
    main()
