"""Public SSD intra-chunk op, the Mamba-2 prefill's quadratic part.

On CUDA tensors it launches the hand-written kernel (``kernels/csrc/ssd.cu``)
or raises; the plain version in ``ref.py`` runs only for tensors on the
CPU. Operands are f32 views with a contiguous last dim, read through their
strides: ``ssd_scan`` passes its activations as they lie and B and C with
stride 0 over heads. The kernel's outputs are views whose memory is the
scan's layout — y ``(G, Q, H, P)``, the state ``(G, H, P, N)`` — so the
scan neither copies nor transposes them. ``launches`` counts kernel
launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ssd import ref

launches = 0

_I, _P = ctypes.c_int, ctypes.c_void_p
_Strides = ctypes.c_longlong * 19


def _lib() -> ctypes.CDLL:
    lib = _build.load("ssd")
    lib.ssd_intra_chunk.argtypes = [_I, _P, _P, _P, _P, _P, _P, _Strides, _I,
                                    _I, _I, _I, _I, _P]
    lib.ssd_intra_chunk.restype = ctypes.c_int
    return lib


def _check(x, cs, B, C) -> None:
    G, H, Q, P = x.shape
    N = B.shape[-1]
    if cs.shape != (G, H, Q) or B.shape != (G, H, Q, N) or \
            C.shape != (G, H, Q, N):
        raise ValueError(f"SSD intra-chunk wants x (G,H,Q,P), cs (G,H,Q), "
                         f"B/C (G,H,Q,N); got {tuple(x.shape)}, "
                         f"{tuple(cs.shape)}, {tuple(B.shape)}, "
                         f"{tuple(C.shape)}")
    if any(t.dtype != torch.float32 for t in (x, cs, B, C)):
        raise ValueError("SSD intra-chunk runs in float32")
    if any(t.device != x.device for t in (cs, B, C)):
        raise ValueError("x, cs, B and C must lie on one device")
    if any(t.stride(-1) != 1 for t in (x, B, C)):
        raise ValueError("x, B and C need a contiguous last dim")


def intra_chunk(x, cs, B, C):
    """x (G,H,Q,P), cs (G,H,Q), B/C (G,H,Q,N) f32 → y (G,H,Q,P), states
    (G,H,N,P) f32: y = ((C Bᵀ) ⊙ L) x and st = (B ⊙ exp(cs[-1] − cs))ᵀ x
    per (g, h), with L[t,s] = exp(cs[t] − cs[s]) for t ≥ s, else 0."""
    global launches
    if x.device.type == "cpu":
        return ref.ssd_intra_chunk_ref(x, cs, B, C)
    if x.device.type != "cuda":
        raise ValueError(f"SSD intra-chunk runs on cuda or cpu, not "
                         f"{x.device}")
    _check(x, cs, B, C)
    G, H, Q, P = x.shape
    N = B.shape[-1]
    y = torch.empty((G, Q, H, P), dtype=torch.float32,
                    device=x.device).permute(0, 2, 1, 3)
    st = torch.empty((G, H, P, N), dtype=torch.float32,
                     device=x.device).transpose(2, 3)
    if y.numel() == 0:
        return y, st
    strides = _Strides(*[s for t in (x, cs, B, C, y) for s in t.stride()[:3]],
                       *st.stride())
    lib = _lib()
    err = lib.ssd_intra_chunk(
        x.device.index or 0, _build.ptr(x), _build.ptr(cs), _build.ptr(B),
        _build.ptr(C), _build.ptr(y), _build.ptr(st), strides, G, H, Q, P, N,
        _build.stream(x.device))
    _build.check(lib, err, "ssd_intra_chunk")
    launches += 1
    return y, st
