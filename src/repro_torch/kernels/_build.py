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
import shutil
import subprocess
import time
from pathlib import Path

SRC_DIR = Path(__file__).parent / "csrc"
BUILD_DIR = Path(__file__).parent / "build"
NAMES = ("flash_attention", "flash_attention_bwd", "gemm", "grouped_gemm",
         "paged_attention", "ssd")
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = shutil.which("nvcc") or os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(f"nvcc not found on PATH or under {home}/bin; "
                           "the CUDA kernels cannot be built")
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
    nvcc = _nvcc()
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
