"""The paper's §3.2 chunk-size law (copy of ``repro/core/chunking.py``).

    S_c = min( S_f / f ,  r / (f + nCores) )

``S_f``  — fixed accelerator chunk (OpenMP-dynamic for the fast device)
``f``    — measured relative speed of the accelerator w.r.t. one CPU core
``r``    — remaining iterations
The first operand equalises per-chunk service time across device classes;
the second is guided self-scheduling [Rudolph & Polychronopoulos '89] so the
tail drains with bounded imbalance.
"""
from __future__ import annotations


def cpu_chunk(S_f: float, f: float, r: int, n_cores: int,
              min_chunk: int = 1) -> int:
    """Paper Eq. (§3.2). Returns an integer chunk ≥ min_chunk (capped at r)."""
    if r <= 0:
        return 0
    f = max(f, 1e-9)
    sc = min(S_f / f, r / (f + n_cores))
    return max(min_chunk, min(int(sc), r)) if sc >= 1 else min(min_chunk, r)
