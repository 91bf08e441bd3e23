#!/usr/bin/env python3
"""Time the SSD intra-chunk kernel of one tree of the port on the card.

    python3 tools/ssd_ab.py [--src DIR]

Takes ``repro_torch`` from ``DIR`` (default: this checkout's ``src``), so a
second tree (a ``git archive`` of the parent, say) is timed by the same
timer at the same shapes. Prints the card's name and power limit, then, at
``chip_smoke.py``'s ``SSD_SHAPES``, the kernel's device ms per call
(torch.profiler, 20 calls) and the wrapper's event ms, and profiles one
exact-length mamba2-130m prefill group of the workload's longest prompt
(1827 tokens, 8 chunk rows; ``chip_smoke.py``'s ``prefill_profile``).
Compare two trees in one call, in turns: parent, change, change, parent.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (puts this checkout's src on the path)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the src directory whose repro_torch is timed")
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("ssd_ab: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.src).resolve()))
    import repro_torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.ssd import ops
    from repro_torch.params import init_params
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    print(f"repro_torch from {Path(repro_torch.__file__).parent}")
    dev = torch.device("cuda")
    for G, Q, P, N in chip_smoke.SSD_SHAPES:
        a = chip_smoke.ssd_case(dev, G, Q, P, N)
        by_name, _ = chip_smoke.kernels_ms(lambda: ops.intra_chunk(*a), 20)
        event = chip_smoke.time_ms(lambda: ops.intra_chunk(*a), 20)
        names = ", ".join(f"{name.split('(')[0].split('::')[-1]} {ms:.4f} "
                          f"ms x {n:g}" for name, (ms, n) in by_name.items())
        print(f"ssd G={G}x24 Q={Q} P={P} N={N}: device "
              f"{sum(ms for ms, _ in by_name.values()):.4f} ms ({names}), "
              f"event {event:.4f} ms a call")
    cfg = get_config("mamba2-130m")
    params = init_params(cfg, seed=0, device=dev)
    rng = np.random.default_rng(0)
    lens = rng.integers(16, 2001, 12)
    prompts = [rng.integers(0, cfg.vocab, n).tolist() for n in lens]
    chip_smoke.prefill_profile(cfg, params, prompts[int(np.argmax(lens))],
                               dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
