"""Public Mamba-1 selective scan, the prefill's state recurrence.

On CUDA tensors it launches a hand-written kernel
(``kernels/csrc/selective_scan.cu``) or raises; the plain version in
``ref.py`` runs only for tensors on the CPU. No TPU kernel computes this:
JAX runs it as an ``associative_scan`` inside a ``lax.scan`` over chunks
(``repro/models/mamba.py::mamba1_mixer``). The kernel keeps the state in
registers and walks the steps in order, so ``chunk`` (the plain version's
chunking, JAX's) does not change what it computes. ``launches`` counts
kernel launches (a CUDA graph replay adds what its capture recorded,
``serve/graphs.py``). The kernel has no backward: on the card a call whose
inputs want a gradient raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, _launches
from repro_torch.kernels.selective_scan import ref

launches = 0

# csrc/selective_scan.cu: lanes of one channel, each holding N / LANES
# entries of its state; the widest state it takes
LANES, N_MAX = 8, 64

_I, _P = ctypes.c_int, ctypes.c_void_p


def _lib() -> ctypes.CDLL:
    lib = _build.load("selective_scan")
    lib.selective_scan.argtypes = [_I, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                                   _I, _I, _I, _P]
    lib.selective_scan.restype = ctypes.c_int
    return lib


def _check(x, dt, A, Bm, Cm, h0) -> None:
    B, S, C = x.shape
    N = A.shape[-1]
    if dt.shape != (B, S, C) or A.shape != (C, N) or \
            Bm.shape != (B, S, N) or Cm.shape != (B, S, N) or \
            h0.shape != (B, C, N):
        raise ValueError(f"selective scan wants x, dt (B,S,C), A (C,N), "
                         f"Bm, Cm (B,S,N), h0 (B,C,N); got "
                         f"{[tuple(t.shape) for t in (x, dt, A, Bm, Cm, h0)]}")
    ts = (x, dt, A, Bm, Cm, h0)
    if any(t.dtype != torch.float32 for t in ts):
        raise ValueError("selective scan runs in float32")
    if any(t.device != x.device for t in ts):
        raise ValueError("the selective scan's operands must lie on one "
                         "device")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("the selective scan's operands must be contiguous")
    if N % LANES or not LANES <= N <= N_MAX:
        raise ValueError(f"the selective scan kernel takes a state of a "
                         f"multiple of {LANES} up to {N_MAX}, not {N}")


def selective_scan(x, dt, A, Bm, Cm, h0, chunk: int):
    """x, dt (B,S,C), A (C,N) (negative), Bm, Cm (B,S,N), h0 (B,C,N), f32
    → y (B,S,C), h_last (B,C,N) f32: h_t = exp(dt_t·A)·h_{t-1} +
    (dt_t·x_t)·B_t from h0, and y_t = Σ_n h_t[:, n]·C_t[n]."""
    if x.device.type == "cpu":
        return ref.selective_scan_ref(x, dt, A, Bm, Cm, h0, chunk)
    if x.device.type != "cuda":
        raise ValueError(f"the selective scan runs on cuda or cpu, not "
                         f"{x.device}")
    _check(x, dt, A, Bm, Cm, h0)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, dt, A, Bm, Cm, h0)):
        raise NotImplementedError("the selective scan kernel has no "
                                  "backward: Mamba-1 does not train")
    B, S, C = x.shape
    N = A.shape[-1]
    y = torch.empty_like(x)
    h_last = torch.empty_like(h0)
    if y.numel() == 0:
        return y, h_last.copy_(h0)
    lib = _lib()
    err = lib.selective_scan(
        x.device.index or 0, *(_build.ptr(t) for t in
                               (x, dt, A, Bm, Cm, h0, y, h_last)),
        B, S, C, N, _build.stream(x.device))
    _build.check(lib, err, "selective_scan")
    _launches.bump(__name__, "launches")
    return y, h_last
