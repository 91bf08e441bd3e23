"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` for ``sm_90a`` into its own shared library under ``build/`` next
to this file (ignored by git), named by a hash of its source, the shared
headers ``csrc/*.cuh`` and the flags, so a stale library is never loaded.
Libraries are loaded with ``ctypes``; no PyTorch headers are compiled.
Every C entry point returns ``cudaGetLastError()`` after its launch, and
:func:`check` raises on a non-zero code.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

SRC_DIR = Path(__file__).parent / "csrc"
BUILD_DIR = Path(__file__).parent / "build"
NAMES = ("flash_attention", "flash_attention_bwd", "gemm", "grouped_gemm",
         "paged_attention", "selective_scan", "ssd")
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: dict[str, ctypes.CDLL] = {}


def _tool(name: str) -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = shutil.which(name) or os.path.join(home, "bin", name)
    if not os.path.exists(path):
        raise RuntimeError(f"{name} not found on PATH or under {home}/bin")
    return path


def library_path(name: str) -> Path:
    src = (SRC_DIR / f"{name}.cu").read_bytes()
    src += b"".join(p.read_bytes() for p in sorted(SRC_DIR.glob("*.cuh")))
    digest = hashlib.sha1(src + " ".join(FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"{name}-{digest}.so"


def build(names=NAMES) -> float:
    """Compile every library of ``names`` that is missing, one ``nvcc`` per
    source, all started together. Returns the wall seconds spent."""
    t0 = time.perf_counter()
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return 0.0
    nvcc = _tool("nvcc")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    try:
        for name in todo:
            so = library_path(name)
            tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
            cmd = [nvcc, *FLAGS, "-o", str(tmp), str(SRC_DIR / f"{name}.cu")]
            procs.append((name, so, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        for name, so, tmp, proc in procs:
            log, _ = proc.communicate()
            so.with_suffix(".log").write_text(log)
            if proc.returncode:
                raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
            os.replace(tmp, so)        # atomic: concurrent builds agree
    finally:
        for _, _, _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return time.perf_counter() - t0


# wgmma products, TMA tile loads, mma.sync products, cp.async copies
SASS_OPCODES = ("HGMMA", "UTMALDG", "HMMA", "LDGSTS")


def kernel_label(signature: str) -> str:
    """A kernel's short name, ``flash_fwd_wgmma<128, 128>``, from its
    demangled signature as ``cu++filt`` (``void <unnamed>::f<(int)128,
    (int)128>(...)``) or the profiler (``void (anonymous namespace)::
    f<128, 128>(...)``) gives it: no return type, namespace, casts of
    template arguments or parameters; a bool argument as 0 or 1, as
    ``cu++filt`` gives it."""
    for anon in ("(anonymous namespace)::", "<unnamed>::"):
        signature = signature.replace(anon, "")
    signature = re.sub(r"\(\w[\w ]*\)(?=-?\d)", "", signature)
    signature = re.sub(r"(?<=[<, ])false(?=[,>])", "0", signature)
    signature = re.sub(r"(?<=[<, ])true(?=[,>])", "1", signature)
    base, lt, args = signature.split("(")[0].partition("<")
    return base.split()[-1].split("::")[-1] + lt + args


def _labels(mangled) -> dict[str, str]:
    """{mangled kernel name: its :func:`kernel_label`}, demangled by
    ``cu++filt``."""
    mangled = list(mangled)
    if not mangled:
        return {}
    out = subprocess.run([_tool("cu++filt"), *mangled], capture_output=True,
                         text=True, check=True).stdout.splitlines()
    if len(out) != len(mangled):
        raise RuntimeError(f"cu++filt gave {len(out)} names for "
                           f"{len(mangled)}")
    return {m: kernel_label(d) for m, d in zip(mangled, out)}


def sass_counts(name: str) -> dict[str, dict[str, int]]:
    """{kernel label: {opcode: count}} of :data:`SASS_OPCODES` in the built
    library ``name``'s SASS (``cuobjdump -sass``), for every kernel it
    holds."""
    out = subprocess.run([_tool("cuobjdump"), "-sass",
                          str(library_path(name))], capture_output=True,
                         text=True, check=True).stdout
    counts: dict[str, dict[str, int]] = {}
    cur = None
    ops = re.compile(r"\b(" + "|".join(SASS_OPCODES) + r")\b")
    for line in out.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            cur = counts.setdefault(m.group(1),
                                    dict.fromkeys(SASS_OPCODES, 0))
        elif cur is not None:
            for op in set(ops.findall(line)):      # lines holding each op
                cur[op] += 1
    labels = _labels(counts)
    return {labels[k]: c for k, c in counts.items()}


def ptxas_stats(name: str) -> dict[str, dict[str, int]]:
    """{kernel label: {"registers", "spill_stores", "spill_loads"}} from
    ``-Xptxas -v`` in the build log of the library ``name``."""
    log = library_path(name).with_suffix(".log").read_text()
    stats: dict[str, dict[str, int]] = {}
    cur = None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?(\w+)'?", line)
        if m:
            cur = stats.setdefault(m.group(1), {})
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            cur["spill_stores"], cur["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
    labels = _labels(stats)
    return {labels[k]: v for k, v in stats.items()}


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built on first use."""
    lib = _libs.get(name)
    if lib is None:
        build((name,))
        lib = ctypes.CDLL(str(library_path(name)))
        lib.kernel_error_string.argtypes = [ctypes.c_int]
        lib.kernel_error_string.restype = ctypes.c_char_p
        _libs[name] = lib
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err:
        msg = lib.kernel_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream(device) -> int:
    """The raw handle of ``device``'s current CUDA stream (what
    ``torch.cuda.current_stream(device).cuda_stream`` gives, without making
    a Stream object: a launch's host cost counts on the small-chunk path)."""
    import torch
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    return torch._C._cuda_getCurrentRawStream(index)
