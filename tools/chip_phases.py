#!/usr/bin/env python3
"""Run some of ``chip_smoke.py``'s phases alone on the card.

    python3 tools/chip_phases.py PHASE [PHASE ...] [--lr-d NAME=VALUE]

Builds every kernel, then runs the named phases of ``chip_smoke.py`` in
order (``scan_backward_phase``, ``flash_train_shapes_phase``,
``train_hybrid_phase``, ``train_encdec_phase``, ...), each with its wall
seconds. A phase that takes the kernel entries gets stub entries whose
``paths`` hold every path, so that its launch checks run. ``--lr-d
train_encdec_phase=0.15`` runs that train cell at another lr·d (the
cell's ``lr_d``). Prints the checks that failed last and exits 1 if any
did. Much shorter than the whole script when only a few phases changed.
"""
import argparse
import inspect
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402


class _AllPaths(list):
    def __contains__(self, item):
        return True


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("phases", nargs="+")
    ap.add_argument("--lr-d", action="append", default=[],
                    metavar="PHASE=VALUE")
    args = ap.parse_args()
    lr_d = dict(x.split("=") for x in args.lr_d)
    cards = os.popen("nvidia-smi --query-gpu=name,power.limit "
                     "--format=csv,noheader").read().strip()
    print(cards)
    cs.CARD = cards.splitlines()[0]          # card 0, beside each number
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"kernels built in {_build.build():.1f} s")
    dev = torch.device("cuda")
    entries = [{"name": name, "paths": _AllPaths()}
               for name in cs._counters()]
    for name in args.phases:
        fn = getattr(cs, name)
        if name in lr_d:
            cell = cs.train_cell

            def forced(*a, _v=float(lr_d[name]), **kw):
                return cell(*a, **{**kw, "lr_d": _v})
            cs.train_cell = forced
        t = time.perf_counter()
        if "entries" in inspect.signature(fn).parameters:
            fn(dev, entries)
        else:
            fn(dev)
        print(f"phase {name}: {time.perf_counter() - t:.1f} s", flush=True)
        if name in lr_d:
            cs.train_cell = cell
    print("failed checks:", cs.FAILURES)
    return 1 if cs.FAILURES else 0


if __name__ == "__main__":
    sys.exit(main())
