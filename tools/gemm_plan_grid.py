#!/usr/bin/env python3
"""Device time of the f32 tiled GEMM on the hbb path's chunks, for every
output tile and split of K, beside the choice of ``ops.plan``.

    PYTHONPATH=src python3 tools/gemm_plan_grid.py

Needs a CUDA card (the kernel has no host version). For both sizes of
Fig. 5 (n = ``GEMM_N_MAIN`` and ``GEMM_N_SCALING``) and each S_f of the
sweep, the chunk A[:S_f] of an n x n f32 A times an n x n B runs at each
tile of ``F32_TILES`` no taller than the chunk and each power-of-two split
from 1 to 16, past ``gemm``'s plan; the kernel's device time is the mean
of 5 launches under torch.profiler (``chip_smoke.kernels_ms``). Every
result is held to 1e-5 of the plain product. The device time leaves out
the call's host cost, which the CUDA-event times of ``chip_smoke.py``
include. Exits 1 if a result is wrong or a cell has no profiled kernel.
"""
from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from chip_smoke import kernels_ms  # noqa: E402

REPS = 5
SPLITS = (1, 2, 4, 8, 16)


def device_us(fn) -> float | None:
    """Mean device µs of the gemm kernel over REPS calls of ``fn``; None
    if the profile holds no gemm kernel."""
    runs = [v for k, v in kernels_ms(lambda: [fn() for _ in range(REPS)])
            .items() if "gemm" in k]
    n = sum(c for _, c in runs)
    return 1e3 * sum(ms for ms, _ in runs) / n if n else None


def grid(n: int, dev) -> int:
    """Prints one line per S_f at n x n; returns the number of bad cells."""
    from repro_torch.configs.gemm_paper import FPGA_CHUNK_SWEEP
    from repro_torch.kernels.gemm import ops, ref
    g = torch.Generator(device=dev).manual_seed(0)
    A = torch.randn((n, n), generator=g, device=dev)
    B = torch.randn((n, n), generator=g, device=dev)
    bad = 0
    for sf in FPGA_CHUNK_SWEEP:
        a = A[:sf]
        want = ref.gemm_ref(a, B)
        plan = ops.plan(sf, n, n, torch.float32)
        cells = []
        for bm, bn, bk in ops.F32_TILES:
            if bm > max(sf, ops.F32_TILES[-1][0]):
                continue
            for splits in SPLITS:
                out = ops._launch(a, B, bm, bn, bk, splits)
                ok = float((out - want).abs().max()
                           / want.abs().max()) <= 1e-5
                us = device_us(lambda: ops._launch(a, B, bm, bn, bk, splits))
                bad += not ok or us is None
                mark = "*" if (bm, bn, bk, splits) == plan else ""
                cells.append(f"({bm},{bn})x{splits}{mark} "
                             + ("missing" if us is None else f"{us:.1f}")
                             + ("" if ok else " WRONG"))
        print(f"S_f={sf} ({sf}x{n}x{n}), device us, * = plan {plan}: "
              + "; ".join(cells), flush=True)
    return bad


def main() -> int:
    if not torch.cuda.is_available():
        print("gemm_plan_grid: needs a CUDA device", file=sys.stderr)
        return 1
    from repro_torch.configs.gemm_paper import GEMM_N_MAIN, GEMM_N_SCALING
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    bad = sum(grid(n, dev) for n in (GEMM_N_MAIN, GEMM_N_SCALING))
    if bad:
        print(f"gemm_plan_grid: {bad} cell(s) wrong or missing",
              file=sys.stderr)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
