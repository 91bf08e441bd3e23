"""Quickstart (``examples/quickstart.py``): the public API in ~50 lines.

    PYTHONPATH=src python -m repro_torch.examples.quickstart \
        [--arch gemma2-2b] [--device cpu]

Builds a family-preserving smoke reduction of any registered architecture
on the card (``--device cpu``: on the host), runs one training step on a
``synth_batch``, then prefill + two greedy decode steps.
"""
import argparse

import torch

from repro_torch._device import resolve_device
from repro_torch.configs import get_config, smoke_config
from repro_torch.models.model import synth_batch
from repro_torch.params import n_params
from repro_torch.serve.decode import decode_step
from repro_torch.serve.prefill import prefill
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.step import init_state, make_train_step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma2-2b")
    ap.add_argument("--smoke", action="store_true",
                    help="no-op compatibility flag: the quickstart already "
                         "runs the family-preserving smoke reduction")
    ap.add_argument("--device", default=None,
                    help="default: the CUDA device; 'cpu' runs on the host")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = smoke_config(get_config(args.arch))
    print(f"arch={cfg.name} family={cfg.family} params={n_params(cfg):,}")

    # --- one training step -------------------------------------------------
    state = init_state(cfg, seed=0, device=dev)
    step = make_train_step(cfg, OptConfig(lr=1e-3))
    batch = synth_batch(cfg, batch=2, seq=64,
                        generator=torch.Generator(device=dev).manual_seed(1))
    state, metrics = step(state, batch)
    print(f"train: loss={float(metrics['loss']):.4f} "
          f"|g|={float(metrics['grad_norm']):.3f}")

    if cfg.enc_dec:
        print("(enc-dec serving demo: see tests/test_serve.py)")
        return

    # --- prefill + decode ---------------------------------------------------
    params = state["params"]
    with torch.no_grad():
        toks = torch.randint(0, cfg.vocab, (1, 12), device=dev,
                             generator=torch.Generator(device=dev)
                             .manual_seed(2))
        logits, cache = prefill(cfg, params, toks, max_len=32)
        nxt = torch.argmax(logits, -1)
        print(f"prefill: next token {int(nxt[0])}")
        for t in range(2):
            pos = torch.full((1,), 12 + t, dtype=torch.int32, device=dev)
            logits, cache = decode_step(cfg, params, cache, nxt, pos)
            nxt = torch.argmax(logits, -1)
            print(f"decode[{t}]: token {int(nxt[0])}")


if __name__ == "__main__":
    main()
