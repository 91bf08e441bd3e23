#!/usr/bin/env python3
"""How often a one-layer dense draft agrees with a softened jamba layer.

    PYTHONPATH=src python3 tools/jamba_draft_agreement.py [ALPHA ...]

Builds jamba-v0.1-52b at its published width cut to one layer (Mamba-1 +
dense FFN, f32, seed 0) on the CPU and ``chip_smoke.py::jamba_draft``'s
draft (one dense GQA layer at jamba's width, seed 1, sharing the target's
embedding, final norm and unembedding). For each ALPHA (default 0.05,
0.002, 0.0005) both models' ``wo`` and ``w_down`` are scaled by it, and
the script prints how many of the last-token argmaxes of 7 prefixes of 2
random prompts agree: the draft's acceptance at that softening. Takes
~30 s and ~4 GB.
"""
import dataclasses
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
import torch  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.params import init_params  # noqa: E402
from repro_torch.serve.prefill import prefill  # noqa: E402


def scaled(params, alpha: float):
    """A tree sharing ``params``' tensors but its layers' ``wo`` and
    ``w_down``, which are scaled by ``alpha``."""
    layers = [{k: ({n: t * alpha if n in ("wo", "w_down") else t
                    for n, t in b.items()} if isinstance(b, dict) else b)
               for k, b in layer.items()} for layer in params["layers"]]
    return {**params, "layers": layers}


def main() -> int:
    alphas = [float(a) for a in sys.argv[1:]] or [0.05, 0.002, 0.0005]
    cfg = dataclasses.replace(get_config("jamba-v0.1-52b"), n_layers=1,
                              param_dtype="float32")
    target = init_params(cfg, 0, device="cpu")
    dcfg = dataclasses.replace(cfg, family="dense", ssm=None, moe=None)
    draft = {"embed": target["embed"], "final_norm": target["final_norm"],
             "unembed": target["unembed"],
             "layers": init_params(dataclasses.replace(dcfg, vocab=1),
                                   seed=1, device="cpu")["layers"]}
    toks = torch.randint(0, cfg.vocab, (2, 64),
                         generator=torch.Generator().manual_seed(0),
                         dtype=torch.int64).to(torch.int32)
    with torch.no_grad():
        for alpha in alphas:
            t, d = scaled(target, alpha), scaled(draft, alpha)
            agree = n = 0
            for S in range(8, 64, 8):
                lt, _ = prefill(cfg, t, toks[:, :S])
                ld, _ = prefill(dcfg, d, toks[:, :S])
                agree += int((lt.argmax(-1) == ld.argmax(-1)).sum())
                n += toks.shape[0]
            print(f"alpha {alpha}: {agree}/{n} argmaxes agree", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
