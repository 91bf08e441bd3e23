"""The paper's experiment: HBB ``parallel_for`` over GEMM row-blocks with
real heterogeneous executors (port of ``examples/hetero_gemm.py``).

  * accelerator class ("FC"): the hand-written tiled GEMM
    (``kernels/gemm``) on the card, on rows [b, e) of a card-resident A,
    its block copied into the host-side output — the paper's accelerator
    writing into shared memory;
  * core class ("CC"): host threads computing C row by row with numpy, the
    per-row path of the JAX driver.

    python -m repro_torch.examples.hetero_gemm --n 1024
    python -m repro_torch.examples.hetero_gemm --n 256 --device cpu

Prints the Fig. 5 table (configs × S_f: wall time, f, rows by class) and
the heterogeneous-vs-offload-only reduction, and checks every result
against the plain product. On the card the accelerator tier runs the
kernel or raises; ``--device cpu`` runs it through the kernel's plain
version on the host.
"""
from __future__ import annotations

import argparse
import os
import time
from dataclasses import dataclass

import torch

from repro_torch._device import resolve_device
from repro_torch.configs.gemm_paper import FPGA_CHUNK_SWEEP, GEMM_N_MAIN
from repro_torch.core.hbb import Body, Dynamic, Params, RunReport
from repro_torch.kernels.gemm import ops as gemm_ops
from repro_torch.kernels.gemm.ref import gemm_ref

# tolerance of a result against the plain product: max |C - plain| over
# the largest |plain|, as the f32 GEMM checks of chip_smoke.py. The host's
# per-row BLAS and the card sum in other orders, and the error of a sum of
# K products scales with the products, not with the (possibly tiny) result
REL_TOL = 1e-5


class GemmBody(Body):
    """C[b:e] = A[b:e] @ B on two real device-class executors. ``out`` is
    the host-side C both classes write (pinned when A lies on the card).
    Each accelerator chunk runs the kernel at its own shape's plan
    (``kernels/gemm/ops.py::plan``)."""

    def __init__(self, A: torch.Tensor, B: torch.Tensor, out: torch.Tensor):
        self.A, self.B, self.out = A, B, out
        self._A_host = A.cpu().numpy()
        self._B_host = B.cpu().numpy()
        self._out_host = out.numpy()
        self.operatorFPGA(0, 1)                   # build, load and warm

    def operatorFPGA(self, b, e):
        blk = gemm_ops.gemm(self.A[b:e], self.B)
        self.out[b:e].copy_(blk)                  # device → host, blocking

    def operatorCPU(self, b, e):
        # interpreted row-at-a-time numpy: the "slow programmable core"
        for i in range(b, e):
            self._out_host[i] = self._A_host[i] @ self._B_host


@dataclass
class Row:
    """One cell of the Fig. 5 table."""
    ncc: int
    nfc: int
    chunk: int
    wall: float
    report: RunReport
    max_err: float
    ok: bool

    def rows_by_class(self) -> dict[str, int]:
        return self.report.iters_by_kind(
            {r.resource: ("accelerator" if r.resource.startswith("FC")
                          else "core") for r in self.report.records})


def make_operands(n: int, device, seed: int = 0):
    g = torch.Generator(device=device).manual_seed(seed)
    A = torch.randn((n, n), generator=g, device=device)
    B = torch.randn((n, n), generator=g, device=device)
    return A, B


def run(A, B, ncc: int, nfc: int, chunk: int, *, f0: float = 8.0,
        want=None) -> Row:
    """One ``parallel_for`` over the n rows of C = A @ B with ``ncc`` core
    tokens and ``nfc`` accelerator tokens of chunk ``S_f = chunk``, checked
    against ``want`` (default: the plain product on A's device)."""
    n = A.shape[0]
    out = torch.zeros((n, B.shape[1]), pin_memory=A.is_cuda)
    body = GemmBody(A, B, out)
    out.zero_()
    p = Params(num_cpu_tokens=ncc, num_fpga_tokens=nfc, fpga_chunk=chunk,
               f0=f0)
    t0 = time.perf_counter()
    rep = Dynamic(p).parallel_for(0, n, body)
    wall = time.perf_counter() - t0
    if want is None:
        want = gemm_ref(A, B).cpu()
    err = float((out - want).abs().max())
    ok = err <= REL_TOL * float(want.abs().max())
    return Row(ncc, nfc, chunk, wall, rep, err, ok)


def fig5(n: int, ncc: int, chunks=FPGA_CHUNK_SWEEP, *, device=None,
         seed: int = 0, configs=None, printer=print) -> list[Row]:
    """The Fig. 5 sweep at n × n: configs (ncc, 0), (0, 1) and (ncc, 1),
    each accelerator config over ``chunks`` (the core-only config once, at
    the first chunk). Prints one line per cell."""
    dev = resolve_device(device)
    A, B = make_operands(n, dev, seed)
    want = gemm_ref(A, B).cpu()
    rows = []
    for c, f in configs or [(ncc, 0), (0, 1), (ncc, 1)]:
        for chunk in (chunks[:1] if f == 0 else chunks):
            row = run(A, B, c, f, chunk, want=want)
            rows.append(row)
            printer(f"  CC={c} FC={f} S_f={chunk:4d}: {row.wall:8.4f} s  "
                    f"f={row.report.f_final:10.1f}  rows={row.rows_by_class()}"
                    f"  chunks={len(row.report.records)}  max err "
                    f"{row.max_err:.3g} ({'ok' if row.ok else 'FAIL'})")
    return rows


def reduction(rows: list[Row]) -> tuple[float, float, float]:
    """(offload-only best s, heterogeneous best s, time reduction): the
    paper's §6 claim is a 25–50 % reduction."""
    t_off = min(r.wall for r in rows if r.ncc == 0 and r.nfc > 0)
    t_het = min(r.wall for r in rows if r.ncc > 0 and r.nfc > 0)
    return t_off, t_het, 1.0 - t_het / t_off


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=GEMM_N_MAIN)
    ap.add_argument("--ncc", type=int,
                    default=max(1, (os.cpu_count() or 2) - 1),
                    help="core tokens (default: the host's cores but one, "
                         "which drives the card)")
    ap.add_argument("--chunks", default=",".join(map(str, FPGA_CHUNK_SWEEP)),
                    help="accelerator chunk sizes S_f, comma-separated")
    ap.add_argument("--device", default=None,
                    help="accelerator device (default: the card)")
    args = ap.parse_args(argv)
    chunks = tuple(int(c) for c in args.chunks.split(","))
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        name = torch.cuda.get_device_name(dev)
    else:
        name = "host CPU (the kernel's plain version)"
    print(f"GEMM {args.n}×{args.n} f32 on {name}; {args.ncc} core tokens of "
          f"{os.cpu_count()} host cores; config → wall time (s), f, rows by "
          "class")
    rows = fig5(args.n, args.ncc, chunks, device=dev)
    t_off, t_het, red = reduction(rows)
    print(f"\noffload-only best {t_off:.4f} s, heterogeneous best "
          f"{t_het:.4f} s → reduction {100 * red:.1f} % (paper §6: 25–50 %)")
    return 0 if all(r.ok for r in rows) else 1


if __name__ == "__main__":
    raise SystemExit(main())
