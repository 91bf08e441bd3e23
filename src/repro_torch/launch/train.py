"""Training launcher (``repro/launch/train.py``), on the card.

    PYTHONPATH=src python -m repro_torch.launch.train --arch mistral-nemo-12b \
        --steps 50 --batch 8 --seq 128 [--smoke] [--microbatches 2] \
        [--compression int8] [--moments int8] [--ckpt-dir DIR] \
        [--device cpu]

Any decoder the port trains (``check_trainable``) on ``SyntheticLM``'s
token batches: the GQA decoders, ``phi3.5-moe-42b-a6.6b`` (MoE),
``deepseek-v2-236b`` (MLA + MoE), ``mamba2-130m`` (Mamba-2),
``jamba-v0.1-52b`` (Mamba-1 + attention + MoE) and ``internvl2-26b`` (as
text); an MoE model's rows print its ``moe_aux``. whisper's loss wants
frames, which the token stream does not carry (as in the JAX launcher):
train it through ``models.model.synth_batch`` and ``make_train_step``
(``examples/quickstart.py``).

``--smoke`` is always on, as in the JAX launcher: it trains the
family-preserving reduction of the arch (``smoke_config``). Without
``--ckpt-dir`` the checkpoints go to a temporary directory that is removed
at the end.
"""
from __future__ import annotations

import argparse
import tempfile

from repro_torch.configs import get_config, smoke_config
from repro_torch.data.loader import PrefetchLoader
from repro_torch.data.synthetic import SyntheticLM
from repro_torch.train.compression import CompressionConfig
from repro_torch.train.loop import LoopConfig, train_loop
from repro_torch.train.optimizer import OptConfig


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--compression", choices=["none", "int8", "topk"],
                    default="none")
    ap.add_argument("--moments", choices=["float32", "int8"],
                    default="float32")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="default: the CUDA device; 'cpu' runs on the host")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_config(cfg)
    ocfg = OptConfig(lr=args.lr, warmup_steps=max(2, args.steps // 10),
                     decay_steps=args.steps, moments_dtype=args.moments)
    ccfg = CompressionConfig(kind=args.compression)
    data = SyntheticLM(cfg.vocab, args.seq, seed=args.seed)

    def log(step, row):
        if step % max(1, args.steps // 20) == 0:
            aux = f" aux {row['moe_aux']:.4f}" if "moe_aux" in row else ""
            print(f"step {step:5d} loss {row['loss']:.4f}{aux} "
                  f"|g| {row['grad_norm']:.3f} lr {row['lr']:.2e} "
                  f"{row['tokens'] / row['dt']:.0f} tok/s", flush=True)

    with tempfile.TemporaryDirectory(prefix="repro_torch_ckpt_") as tmp:
        lcfg = LoopConfig(ckpt_dir=args.ckpt_dir or tmp,
                          total_steps=args.steps,
                          ckpt_every=args.ckpt_every)
        loader = PrefetchLoader(data.iterator(args.batch), args.device)
        try:
            res = train_loop(cfg, ocfg, lcfg, iter(loader), ccfg=ccfg,
                             on_step=log, seed=args.seed,
                             device=args.device,
                             microbatches=args.microbatches)
        finally:
            loader.close()
    print(f"done: {len(res.history)} steps, restarts={res.restarts}, "
          f"resumed_from={res.resumed_from}, "
          f"final loss {res.history[-1]['loss']:.4f}")


if __name__ == "__main__":
    main()
