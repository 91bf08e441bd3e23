#!/usr/bin/env python3
"""Where the wall time of Fig. 5's runs goes on the card, at Python's
default thread switch interval and at a short one.

    PYTHONPATH=src python3 tools/fig5_switch_interval.py

Needs a CUDA card. At the 1024² f32 GEMM of Fig. 5 and each S_f of the
sweep, runs offload-only (0, 1) and heterogeneous (the host's cores but
one, 1) ``REPS`` times each, alternating, with ``sys.setswitchinterval``
at the interpreter's default (5 ms) and at 1e-4 s. Per cell it prints
the wall ms (median, least, largest), the rows the cores took (median)
and when the accelerator token's last chunk ended (median ms after the
start, from the ``parallel_for`` records): the wall time beyond that is
the threads' start, hand-offs and join. For S_f 256 it also prints one
heterogeneous run's chunk timeline. It times whatever ``repro_torch`` is
first on ``PYTHONPATH``, so one call can time two trees.
"""
from __future__ import annotations

import os
import statistics
import subprocess
import sys

import torch

REPS = 7
INTERVALS = (None, 1e-4)          # None: the interpreter's default


def main() -> int:
    if not torch.cuda.is_available():
        print("fig5_switch_interval: needs a CUDA device", file=sys.stderr)
        return 1
    from repro_torch.configs.gemm_paper import FPGA_CHUNK_SWEEP, GEMM_N_MAIN
    from repro_torch.examples import hetero_gemm
    from repro_torch.kernels.gemm.ref import gemm_ref
    import repro_torch
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    print(f"repro_torch from {os.path.dirname(repro_torch.__file__)}")
    dev = torch.device("cuda")
    n = GEMM_N_MAIN
    ncc = max(1, (os.cpu_count() or 2) - 1)
    A, B = hetero_gemm.make_operands(n, dev)
    want = gemm_ref(A, B).cpu()
    default = sys.getswitchinterval()
    bad = 0
    for interval in INTERVALS:
        sys.setswitchinterval(interval or default)
        print(f"switch interval {sys.getswitchinterval() * 1e3:g} ms, "
              f"{n}² f32, {ncc} core tokens, 1 accelerator token")
        for chunk in FPGA_CHUNK_SWEEP:
            rows = {0: [], ncc: []}
            for _ in range(REPS):
                for c in rows:
                    r = hetero_gemm.run(A, B, c, 1, chunk, want=want)
                    bad += not r.ok
                    rows[c].append(r)
            for c, rs in rows.items():
                walls = [1e3 * r.wall for r in rs]
                core = statistics.median(r.rows_by_class().get("core", 0)
                                         for r in rs)
                fc_end = statistics.median(1e3 * max(
                    (x.t_end for x in r.report.records
                     if x.resource.startswith("FC")), default=0.0)
                    for r in rs)
                print(f"  CC={c} S_f={chunk:4d}: wall ms median "
                      f"{statistics.median(walls):.3f} least {min(walls):.3f} "
                      f"largest {max(walls):.3f}; core rows {core:g}; "
                      f"accelerator's last chunk ended at {fc_end:.3f} ms",
                      flush=True)
            if chunk == FPGA_CHUNK_SWEEP[-1]:
                r = rows[ncc][REPS // 2]
                print(f"  timeline of one CC={ncc} S_f={chunk} run (wall "
                      f"{1e3 * r.wall:.3f} ms): " + "; ".join(
                          f"{x.resource} [{x.begin},{x.end}) "
                          f"{1e3 * x.t_start:.3f}-{1e3 * x.t_end:.3f}"
                          for x in sorted(r.report.records,
                                          key=lambda x: x.t_start)))
    sys.setswitchinterval(default)
    if bad:
        print(f"fig5_switch_interval: {bad} result(s) differ from the plain "
              "product", file=sys.stderr)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
