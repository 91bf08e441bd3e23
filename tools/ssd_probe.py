#!/usr/bin/env python3
"""Where the SSD tensor-core kernel (``ssd_mma``) spends its time, on the card.

    python3 tools/ssd_probe.py

At ``chip_smoke.py``'s main SSD shape (8 chunk rows x 24 heads, Q 256, P 64,
N 128, B and C shared by the heads) it prints:

- the device time (CUDA events, 30 back-to-back calls with preallocated
  outputs) of the kernel as built, and of copies of ``csrc/ssd.cu`` with
  one stage taken out: no global loads ("noload", the products then run on
  whatever shared memory holds), no y products ("noy"), no score products
  ("noscores"), no block barriers ("nosync", racy); each with its relative
  error against the plain version (meaningful only for the kernel as
  built);
- a per-block timeline of the kernel as built (``%globaltimer`` at the start
  and end of every block, from an instrumented copy): per block class, the
  blocks' durations, the duration per step of ``ops._costs`` and the start
  times, and the makespan;
- device times of several plans (heads per y block, per state block, the
  state class's place) at 8 and 2 chunk rows of 256 and at one row of 97,
  beside the makespan ``ops.ssd_plan`` predicts for each.

The copies are built under ``kernels/build/`` (ignored by git), each by its
own hash. The substitutions match the source as it stands; a change to
``ssd.cu`` that breaks one makes this script stop with the text it missed.
"""
from __future__ import annotations

import ctypes
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (puts this checkout's src on the path)

# (pattern, replacement) pairs applied with re.subn, each exactly once
Y_CALL = (r"      y_step\(sf, st \+ q \* MP, st \+ MT \* MP, ct, "
          r"si == ti \? tl : MT, q, gq,\n             acc\);")
VARIANTS = {
    "noload": [
        (r"    if \(k < items\) \{\n      const int s0 = \(k / per\) \* MT",
         "    if (false) {\n      const int s0 = (k / per) * MT"),
        (r"    if \(k < steps\) \{\n      const int s0 = k \* SK;",
         "    if (false) {\n      const int s0 = k * SK;")],
    "noy": [(Y_CALL, "      acc[0][0][0] += sf[0] + st[0];")],
    "noscores": [(r"      scores_step\(ca \+ 64 \* hn,",
                  "      if (false) scores_step(ca + 64 * hn,")],
    "nosync": [(r"  cp_async_wait<MSTAGES - 2>\(\);\n  __syncthreads\(\);",
                "  cp_async_wait<MSTAGES - 2>();")],
    "timeline": [
        (r"(__global__ void __launch_bounds__\(MTHREADS, 1\) ssd_mma\("
         r"const MmaArgs a\) \{\n  extern __shared__ __align__\(16\) "
         r"float smem\[\];)",
         "__device__ unsigned long long g_tl[2 * 16384];\n"
         "__device__ unsigned long long gtime() {\n"
         "  unsigned long long t;\n"
         "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t));\n"
         "  return t;\n}\n"
         "__device__ void rec(unsigned long long t0) {\n"
         "  __syncthreads();\n"
         "  if (threadIdx.x == 0 && blockIdx.x < 16384) {\n"
         "    g_tl[2 * blockIdx.x] = t0;\n"
         "    g_tl[2 * blockIdx.x + 1] = gtime();\n  }\n}\n"
         "\\1\n  const unsigned long long t_0 = gtime();"),
        (r"(        state_block\(a, smem, r / ngs, \(r % ngs\) \* a\.hs\);)"
         r"\n        return;", "\\1\n        rec(t_0);\n        return;"),
        (r"(        y_block\(a, smem, r / ngy, ti, \(r % ngy\) \* a\.hpb\);)"
         r"\n        return;", "\\1\n        rec(t_0);\n        return;"),
        (r"const char\* kernel_error_string\(int err\) \{",
         "int ssd_read_timeline(void* dst) {\n"
         "  return (int)cudaMemcpyFromSymbol(dst, g_tl, sizeof(g_tl));\n}\n"
         "const char* kernel_error_string(int err) {")],
}
PLANS = {(8, 256): [(4, 2, 2), (4, 1, 2), (3, 2, 2), (2, 2, 0)],
         (2, 256): [(2, 2, 0), (1, 2, 0), (4, 2, 2)],
         (1, 97): [(1, 1, 1), (2, 2, 0), (4, 2, 1)]}


def variant_lib(name: str, subs):
    """The ssd library built from a copy of csrc with ``subs`` applied."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.ssd import ops
    base = Path(ops.__file__).resolve().parents[1] / "csrc"
    d = _build.BUILD_DIR / f"probe_{name}"
    if d.exists():
        shutil.rmtree(d)
    shutil.copytree(base, d)
    text = (d / "ssd.cu").read_text()
    for pat, rep in subs:
        text, n = re.subn(pat, rep, text)
        if n != 1:
            raise SystemExit(f"{name}: {pat!r} matched {n} times")
    (d / "ssd.cu").write_text(text)
    _build.SRC_DIR = d
    _build._libs.pop("ssd", None)
    try:
        return ops._lib(), _build.ptxas_stats("ssd").get("ssd_mma")
    finally:
        _build.SRC_DIR = base


class Call:
    """One ssd_intra_chunk_mma launch with a given plan, outputs made once."""

    def __init__(self, args, plan):
        import torch
        from repro_torch.kernels import _build
        from repro_torch.kernels.ssd import ops
        x, cs, B, C = args
        G, H, Q, P = x.shape
        N = B.shape[-1]
        dev = x.device
        self.y = torch.empty((G, Q, H, P), device=dev).permute(0, 2, 1, 3)
        self.st = torch.empty((G, H, P, N), device=dev).transpose(2, 3)
        self.strides = ops._Strides(
            *[s for t in (x, cs, B, C, self.y) for s in t.stride()[:3]],
            *self.st.stride())
        self.ptrs = [_build.ptr(t) for t in (x, cs, B, C, self.y, self.st)]
        self.dims, self.plan = (G, H, Q, P, N), tuple(plan)
        self.stream = _build.stream(dev)

    def __call__(self, lib):
        err = lib.ssd_intra_chunk_mma(0, *self.ptrs, self.strides, *self.dims,
                                      *self.plan, self.stream)
        if err:
            raise RuntimeError(f"ssd_intra_chunk_mma: CUDA error {err}")
        return self.y, self.st


def event_us(fn, calls: int = 30) -> float:
    import torch
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) * 1e3 / calls


def rel_err(got, want) -> float:
    return max(float((g - w).abs().max() / w.abs().max())
               for g, w in zip(got, want))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("ssd_probe: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels.ssd import ops, ref
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    dev = torch.device("cuda")
    args = chip_smoke.ssd_case(dev, 8, 256, 64, 128)
    want = ref.ssd_intra_chunk_ref(*args)
    plan = ops.plan_of(args[0], args[2], args[3])
    call = Call(args, plan[:3])
    print(f"G=8x24 Q=256 P=64 N=128, plan {tuple(plan)}")
    for name, subs in [("as built", [])] + [
            (k, v) for k, v in VARIANTS.items() if k != "timeline"]:
        lib, regs = variant_lib(name.replace(" ", "_"), subs)
        err = rel_err(call(lib), want)
        print(f"  {name:9s} {event_us(lambda: call(lib)):8.2f} us  "
              f"(rel err {err:.2g}; ptxas {regs})")

    lib, _ = variant_lib("timeline", VARIANTS["timeline"])
    lib.ssd_read_timeline.argtypes = [ctypes.c_void_p]
    call(lib)
    torch.cuda.synchronize()
    tl = (ctypes.c_ulonglong * (2 * 16384))()
    lib.ssd_read_timeline(tl)
    spans = [(tl[2 * i], tl[2 * i + 1]) for i in range(plan.blocks)]
    t0 = min(a for a, _ in spans)
    print(f"  timeline: makespan {(max(b for _, b in spans) - t0) / 1e3:.2f}"
          f" us over {plan.blocks} blocks")
    ys, (s_steps, s_blocks) = ops._costs(8, 24, 256, 128, plan.hpb, plan.hs)
    classes = [(f"y t{len(ys) - 1 - i}", c, n) for i, (c, n) in
               enumerate(ys)]
    classes.insert(plan.state_pos, ("state", s_steps, s_blocks))
    first = 0
    for name, steps, n in classes:
        d = [(b - a) / 1e3 for a, b in spans[first:first + n]]
        st = [(a - t0) / 1e3 for a, _ in spans[first:first + n]]
        print(f"    {name:6s} {n:4d} blocks of {steps:3d} steps: "
              f"{min(d):6.2f} / {sum(d) / n:6.2f} / {max(d):6.2f} us "
              f"(min / mean / max; {sum(d) / n / steps:.3f} us a step), "
              f"start {min(st):.2f}-{max(st):.2f} us")
        first += n

    lib, _ = variant_lib("as_built", [])
    for (G, Q), plans in PLANS.items():
        a = chip_smoke.ssd_case(dev, G, Q, 64, 128)
        w = ref.ssd_intra_chunk_ref(*a)
        best = ops.ssd_plan(G, 24, Q, 128, True)
        row = []
        for pl in plans:
            c = Call(a, pl)
            err = rel_err(c(lib), w)
            ys, (s_steps, s_blocks) = ops._costs(G, 24, Q, 128, pl[0], pl[1])
            order = [c_ for c_, n in ys[:pl[2]] for _ in range(n)] + \
                [s_steps] * s_blocks + \
                [c_ for c_, n in ys[pl[2]:] for _ in range(n)]
            row.append(f"{pl}: {event_us(lambda: c(lib)):.2f} us "
                       f"(model {ops._makespan(order)}, err {err:.1g})")
        print(f"  plans G={G} Q={Q} (ssd_plan {tuple(best[:3])}): " +
              "; ".join(row))
    return 0


if __name__ == "__main__":
    sys.exit(main())
