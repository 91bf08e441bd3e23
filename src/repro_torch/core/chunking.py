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


def accelerator_chunk(S_f: int, r: int) -> int:
    """OpenMP-dynamic: fixed S_f, capped by the remaining iterations."""
    return max(0, min(S_f, r))


def proportional_split(total: int, speeds, quantum: int = 1) -> list[int]:
    """Equal-service-time split of `total` across resources with relative
    speeds `speeds`, rounded to `quantum` (largest-remainder). Used by the
    heterogeneous batch partitioner at steady state."""
    s = sum(speeds)
    assert s > 0 and total % quantum == 0, (speeds, total, quantum)
    units = total // quantum
    raw = [units * v / s for v in speeds]
    base = [int(x) for x in raw]
    rem = units - sum(base)
    order = sorted(range(len(raw)), key=lambda i: raw[i] - base[i],
                   reverse=True)
    for i in order[:rem]:
        base[i] += 1
    return [b * quantum for b in base]
