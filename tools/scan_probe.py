#!/usr/bin/env python3
"""Where the Mamba-1 selective scan kernels spend their time, on the card.

    python3 tools/scan_probe.py [--src DIR]

Takes ``repro_torch`` and ``csrc/selective_scan.cu`` from ``DIR`` (a
checkout's ``src``; default this checkout's), so a parent's ``git archive``
is probed by the same script. At ``chip_smoke.py``'s scan shapes it prints:

- the card's name and power limit and its maximum SM clock;
- for the kernel as built and for copies of its source with one stage
  taken out or changed (``OLD`` or ``NEW``, chosen by which source it
  is): the serving forward's event ms at B 1 and B 8 (S 2000, C 8192,
  N 16) with its relative error against the plain version (meaningful
  only where the variant keeps the arithmetic), the training forward (the
  instance that saves the checkpoint states) and the backward at jamba's
  training layer (B 2, S 2048), and ptxas's registers and spills at N 16;
- for the kernel as built, the backward's two launches' device ms;
- the step loop of the serving forward at N 16 in the built SASS
  (``cuobjdump -sass``): the innermost loop that holds the exps, its
  instructions, MUFU ops and steps, and its most frequent opcodes.

The forward's ablations read as: ``loads`` stages the inputs and stores
nothing (y's store is guarded by a test that never holds but that the
compiler cannot drop), ``steps`` runs the steps on whatever the staging
buffers hold in place of the loads (the first kernel: constants) and
stores nothing, ``io`` loads and stores with a sum in place of the state
update, ``steps+stores`` takes out the loads alone; ``lanesK`` splits a
channel's state over K lanes. On the first kernel ``exp2`` takes one
``ex2.approx`` of A pre-scaled by log2(e) in place of ``expf`` (in both
kernels); on the redesigned one ``expf`` goes back to expf, ``ring2``
keeps two tiles in the ring instead of four, ``ts8`` halves the tile and
checkpoint interval to 8 steps (twice the saved states, and twice the
backward's intervals, of half the registers), ``bwd128`` runs the
backward in 128-thread blocks (32 channels), ``bwd_exp2x`` takes the
decays again in the reverse walk instead of reading the kept ones,
``bwd_sub8`` walks 8-step sub-tiles (fewer registers, 1.5 exps an entry)
and ``bwd_noreduce`` drops the backward's sums of dB and dC over
channels (their cost). Every
variant is compiled in its own directory under ``kernels/build/``
(ignored by git), all at once. A substitution that no longer matches the
source stops the script with the text it missed.
"""
from __future__ import annotations

import argparse
import ctypes
import re
import shutil
import subprocess
import sys
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (puts this checkout's src on the path)
import torch  # noqa: E402

LOG2E = "1.4426950408889634f"
FWD_ASSERTS = r"static_assert\(fwd_smem_bytes\(\d+\) == \d+, \"[^\"]*\"\);\n"
BWD_ASSERTS = r"static_assert\(bwd_smem_bytes\(\d+\) == \d+, \"[^\"]*\"\);\n"
FLANES_ASSERTS = r"static_assert\(flanes\(\d+\) == \d+, \"[^\"]*\"\);\n"
NEVER = "1234.5f"        # a y value the guarded store tests for


def _lanes(k: int, old: bool) -> list:
    """Substitutions that split a channel's state over ``k`` lanes."""
    if old:
        subs = [(r"constexpr int LANES = 8;", f"constexpr int LANES = {k};",
                 1)]
        if k == 1:     # N 16 is 16 entries a lane: an instance the source lacks
            subs.append((
                r"    default: err = launch<8>\(x, dt, A, Bm, Cm, h0, y, "
                r"h_last, hs, B, S, C, s\);",
                "    case 8: err = launch<8>(x, dt, A, Bm, Cm, h0, y, h_last,"
                " hs, B, S, C, s); break;\n    default: err = launch<16>(x, "
                "dt, A, Bm, Cm, h0, y, h_last, hs, B, S, C, s);", 1))
        return subs
    return [(r"return N <= 32 \? 2 : 4;", f"return {k};", 1),
            (FWD_ASSERTS, "", 2), (FLANES_ASSERTS, "", 2)]


# The first kernel: a tile of 32 steps staged by plain loads, 8 lanes a
# channel, expf in both kernels
OLD_STEP_LOOP = (r"    for \(int r = 0; r < ts; \+\+r\) \{\n      const float d = "
                 r"sdt\[r\]\[ch\];.*?      if \(lane == 0\) sy\[r\]\[ch\] = "
                 r"part;\n    \}\n")
OLD_NO_STEPS = ("    for (int r = lane; r < ts; r += LANES)\n"
                "      sy[r][ch] = sx[r][ch] + sdt[r][ch] + sB[r][ch % N] + "
                "sC[r][ch % N];\n")
OLD_NO_LOADS = [
    (r"sx\[r\]\[k\] = ok \? x\[off\] : 0\.f;", "sx[r][k] = ok ? 0.01f * k : 0.f;",
     1),
    (r"sdt\[r\]\[k\] = ok \? dt\[off\] : 0\.f;",
     "sdt[r][k] = ok ? 0.02f * r : 0.f;", 1),
    (r"sB\[r\]\[k\] = ok \? Bm\[off\] : 0\.f;", "sB[r][k] = ok ? 0.5f : 0.f;", 1),
    (r"sC\[r\]\[k\] = ok \? Cm\[off\] : 0\.f;", "sC[r][k] = ok ? 0.25f : 0.f;",
     1)]
OLD_NO_STORES = [(r"if \(c0 \+ k < C\) y\[", f"if (sy[r][k] == {NEVER}) y[", 1)]
OLD = {
    "loads": [(OLD_STEP_LOOP, OLD_NO_STEPS, 1)] + OLD_NO_STORES,
    "io": [(OLD_STEP_LOOP, OLD_NO_STEPS, 1)],
    "steps": OLD_NO_LOADS + OLD_NO_STORES,
    "steps+stores": OLD_NO_LOADS,
    "exp2": [
        (r"return fmaf\(expf\(d \* a\), h, u \* b\);",
         "float e;\n  asm(\"ex2.approx.ftz.f32 %0, %1;\" : \"=f\"(e) : "
         "\"f\"(d * a));\n  return fmaf(e, h, u * b);", 1),
        (r"a\[i\] = live \? A\[\(long long\)c \* N \+ n\] : 0\.f;",
         f"a[i] = live ? A[(long long)c * N + n] * {LOG2E} : 0.f;", 2),
        (r"const float ai = expf\(d \* a\[i\]\);",
         "float ai;\n          asm(\"ex2.approx.ftz.f32 %0, %1;\" : "
         "\"=f\"(ai) : \"f\"(d * a[i]));", 1)],
    **{f"lanes{k}": _lanes(k, True) for k in (4, 2, 1)},
}

# The source as redesigned: a ring of cp.async tiles, flanes(N) lanes a
# channel in the forward, one ex2 of a pre-scaled A
NEW_NO_STEPS = [(r"e\[r\]\[i\] = decay\(d, a2\[i\]\);", "e[r][i] = d;", 1),
                (r"h\[i\] = step\(h\[i\], e\[r\]\[i\], ub\[r\]\[i\]\);\n\s*"
                 r"v\[r\] = fmaf\(h\[i\], cv\[i\], v\[r\]\);",
                 "v[r] += e[r][i] + ub[r][i] + cv[i];", 1)]
NEW_NO_LOADS = [(r"(  float\* s = smem \+ \(k % FSTAGES\) \* STAGE;\n)(  stage<)",
                 "\\1  if (k >= 0) return;\n\\2", 1)]
NEW_NO_STORES = [(r"unstage<FCPB, FTHREADS>\(yb,",
                  "if (S < 0) unstage<FCPB, FTHREADS>(yb,", 2)]
NEW = {
    "loads": NEW_NO_STEPS + NEW_NO_STORES,
    "io": NEW_NO_STEPS,
    "steps": NEW_NO_LOADS + NEW_NO_STORES,
    "steps+stores": NEW_NO_LOADS,
    "expf": [(r"return ex2\(__fmul_rn\(d, a2\)\);",
              "return expf(__fmul_rn(d, a2) * 0.6931471805599453f);", 1)],
    "ring2": [(r"constexpr int FSTAGES = 4;", "constexpr int FSTAGES = 2;", 1),
              (FWD_ASSERTS, "", 2)],
    **{f"lanes{k}": _lanes(k, False) for k in (8, 4)},
    "ts8": [(r"constexpr int TS = 16;", "constexpr int TS = 8;", 1),
            (FWD_ASSERTS, "", 2), (BWD_ASSERTS, "", 2)],
    "bwd128": [(r"constexpr int BTHREADS = 256;", "constexpr int BTHREADS = 128;",
                1), (BWD_ASSERTS, "", 2)],
    "bwd_exp2x": [
        (r"__fmul_rn\(e\[q\]\[(\d)\]\[i\], hst\[q\]",
         "__fmul_rn(decay(\\1 ? d.y : d.x, a2[\\1][i]), hst[q]", 2),
        (r"__fmul_rn\(g\[(\d)\]\[i\], e\[q\]\[\d\]\[i\]\)",
         "__fmul_rn(g[\\1][i], decay(\\1 ? d.y : d.x, a2[\\1][i]))", 2)],
    "bwd_sub8": [(r"return entries <= 4 \? TS :", "return entries <= 4 ? TS / 2 :",
                  1), (BWD_ASSERTS, "", 2)],
    "bwd_noreduce": [
        (r"store_k\(red \+ ", "if (S < 0) store_k(red + ", 2),
        (r"bwd_sums<N, SUB>\(", "if (S < 0) bwd_sums<N, SUB>(", 2)],
}
# ops.py constants a variant's launches must follow
NEW["bwd128_exp2x"] = NEW["bwd128"] + NEW["bwd_exp2x"]
VARIANT_OPS = {"ts8": {"TS": 8}, "bwd128": {"BCPB": 32},
               "bwd128_exp2x": {"BCPB": 32}}


def _variants(text: str) -> tuple[str, dict]:
    if "constexpr int flanes(int N)" in text:
        return "redesigned", NEW
    if "constexpr int LANES = 8;" in text:
        return "first kernel", OLD
    raise SystemExit("scan_probe: selective_scan.cu is neither the first "
                     "kernel nor the redesigned one")


def build_all(csrc: Path, variants: dict) -> dict[str, tuple[Path, str]]:
    """{variant: (library, ptxas log)}, every copy compiled at once."""
    from repro_torch.kernels import _build
    base = _build.BUILD_DIR / "scan_probe"
    if base.exists():
        shutil.rmtree(base)
    jobs = {}
    for name, subs in {"as built": [], **variants}.items():
        d = base / re.sub(r"\W", "_", name)
        shutil.copytree(csrc, d)
        text = (d / "selective_scan.cu").read_text()
        for pat, rep, want in subs:
            text, n = re.subn(pat, lambda m, r=rep: m.expand(r), text,
                             flags=re.S)
            if n != want:
                raise SystemExit(f"{name}: {pat!r} matched {n} times, not "
                                 f"{want}")
        (d / "selective_scan.cu").write_text(text)
        so = d / "libscan.so"
        jobs[name] = (so, subprocess.Popen(
            [_build._tool("nvcc"), *_build.FLAGS, "-o", str(so),
             str(d / "selective_scan.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    out = {}
    for name, (so, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"{name}: nvcc failed:\n{log}")
        out[name] = (so, log)
    return out


def install(so: Path) -> None:
    """Make ``ops`` launch the library ``so``."""
    from repro_torch.kernels import _build
    lib = ctypes.CDLL(str(so))
    lib.kernel_error_string.argtypes = [ctypes.c_int]
    lib.kernel_error_string.restype = ctypes.c_char_p
    _build._libs["selective_scan"] = lib


def ptxas(log: str) -> dict[str, tuple]:
    """{kernel label: (registers, spill bytes)} from a build log."""
    from repro_torch.kernels import _build
    stats, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?(\w+)'?", line)
        if m:
            cur = stats.setdefault(m.group(1), [0, 0])
        elif cur is not None:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
            if m:
                cur[1] = int(m.group(1)) + int(m.group(2))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                cur[0] = int(m.group(1))
    labels = _build._labels(stats)
    return {labels[k]: tuple(v) for k, v in stats.items()}


def step_loop(so: Path, label: str, npt: int) -> str:
    """The innermost loop of ``label``'s SASS that holds its exps: its
    instruction count, MUFU count, steps (MUFU / ``npt``) and top opcodes."""
    from repro_torch.kernels import _build
    sass = subprocess.run([_build._tool("cuobjdump"), "-sass", str(so)],
                          capture_output=True, text=True, check=True).stdout
    funcs, cur = {}, None
    for line in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            cur = funcs.setdefault(m.group(1), [])
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?"
                     r"([A-Z][A-Z0-9_.]*)([^;]*);", line)
        if m and cur is not None:
            cur.append((int(m.group(1), 16), m.group(2), m.group(3)))
    labels = _build._labels(funcs)
    code = next((v for k, v in funcs.items() if labels[k] == label), None)
    if code is None:
        return f"{label}: not in the SASS ({sorted(labels.values())})"
    loops = []
    for addr, op, args in code:
        m = re.search(r"0x([0-9a-f]+)", args)
        if op.startswith("BRA") and m and int(m.group(1), 16) < addr:
            body = [o for a, o, _ in code if int(m.group(1), 16) <= a <= addr]
            if any(o.startswith("MUFU") for o in body):
                loops.append(body)
    if not loops:
        return f"{label}: no loop holds a MUFU"
    body = min(loops, key=len)
    mufu = sum(o.startswith("MUFU") for o in body)
    steps = max(mufu / npt, 1)
    top = Counter(o.split(".")[0] for o in body).most_common(10)
    return (f"{label}: step loop {len(body)} instructions, {mufu} MUFU, "
            f"{steps:g} steps, {len(body) / steps:.1f} a step a thread; "
            f"{top}")


def event_ms(fn, calls: int) -> float:
    return chip_smoke.time_ms(fn, calls, 3)


def _case(dev, B: int, S: int, C: int, N: int, seed: int) -> tuple:
    g = torch.Generator(device=dev).manual_seed(seed)

    def t(*shape):
        return torch.randn(shape, generator=g, device=dev)
    return (t(B, S, C), torch.nn.functional.softplus(t(B, S, C) - 1.0),
            -torch.exp(0.5 * t(C, N)), t(B, S, N), t(B, S, N), t(B, C, N))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the src directory whose repro_torch is probed")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("scan_probe: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.kernels.selective_scan import ops, ref
    csrc = Path(ops.__file__).resolve().parents[1] / "csrc"
    print(f"probing {csrc}")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,"
                          "clocks.max.sm", "--format=csv,noheader"],
                         capture_output=True, text=True,
                         check=True).stdout.strip())
    which, variants = _variants((csrc / "selective_scan.cu").read_text())
    print(f"source: the {which}")
    libs = build_all(csrc, variants)
    # the instances at N 16: the first kernel's templates took entries a lane
    n16 = "<2" if which == "first kernel" else "<16"
    dev = torch.device("cuda")
    serve = {B: _case(dev, B, 2000, 8192, 16, B) for B in (1, 8)}
    train = _case(dev, *chip_smoke.SCAN_TRAIN, 7)
    g = torch.Generator(device=dev).manual_seed(8)
    dy = torch.randn(train[0].shape, generator=g, device=dev)
    dh = torch.randn(train[5].shape, generator=g, device=dev)
    want = ref.selective_scan_ref(*serve[1], 256)
    for name, (so, log) in libs.items():
        install(so)
        keep = {k: getattr(ops, k) for k in VARIANT_OPS.get(name, {})}
        for k, v in VARIANT_OPS.get(name, {}).items():
            setattr(ops, k, v)
        got = ops.scan_forward(*serve[1], 256)
        err = max(float((a - b).abs().max() / b.abs().max())
                  for a, b in zip(got, want))
        ms = [event_ms(lambda B=B: ops.scan_forward(*serve[B], 256),
                       20 if B == 1 else 10) for B in (1, 8)]
        _, _, hs = ops.scan_forward(*train, 256, save=True)
        save = event_ms(lambda: ops.scan_forward(*train, 256, save=True), 10)
        bwd = event_ms(lambda: ops.selective_scan_bwd(*train[:5], hs, dy,
                                                      dh), 10)
        regs = {k: v for k, v in ptxas(log).items() if n16 in k}
        print(f"  {name:13s} B1 {ms[0]:.4f} ms  B8 {ms[1]:.4f} ms  training "
              f"forward {save:.4f} ms  backward {bwd:.4f} ms  (forward rel "
              f"err {err:.2g}; ptxas at N 16 (registers, spill bytes) "
              f"{regs})", flush=True)
        del hs
        for k, v in keep.items():
            setattr(ops, k, v)
    so, log = libs["as built"]
    install(so)
    _, _, hs = ops.scan_forward(*train, 256, save=True)
    by_name, _ = chip_smoke.kernels_ms(
        lambda: ops.selective_scan_bwd(*train[:5], hs, dy, dh))
    print(f"  as built, B 2 S 2048: the backward's device ms "
          f"{ {k[:48]: round(v[0], 4) for k, v in by_name.items()} } "
          f"(checkpoints every {ops.TS} steps)")
    print(f"  ptxas of the as-built source: {ptxas(log)}")
    lanes = 8 if which == "first kernel" else ops.flanes(16)
    print(f"  SASS: {step_loop(so, f'selective_scan_kernel{n16}, 0>', 16 // lanes)}")
    print(f"  SASS: {step_loop(so, f'selective_scan_bwd_kernel{n16}>', 16 // lanes)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
