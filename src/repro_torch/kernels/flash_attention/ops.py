"""Public flash-attention forward op.

On a CUDA tensor it launches the hand-written kernel
(``kernels/csrc/flash_attention.cu``) or raises; the plain version in
``ref.py`` runs only for tensors on the CPU. ``launches`` counts kernel
launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import ref

launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_DQK = 256           # q/k head dim (MLA prefill: nope 128 + rope 64)
_MAX_DV = 128
_I, _LL, _F, _P = ctypes.c_int, ctypes.c_longlong, ctypes.c_float, \
    ctypes.c_void_p
_ARGTYPES = [_I, _I, _P, _P, _P, _P] + [_LL] * 12 + [_I] * 7 + \
    [_F, _I, _I, _F, _P]


def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    lib.flash_attention_fwd.argtypes = _ARGTYPES
    lib.flash_attention_fwd.restype = ctypes.c_int
    return lib


def _check(q, k, v) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash attention wants 4-D q (B,H,Tq,dh), "
                         "k (B,Hk,Tk,dh), v (B,Hk,Tk,dv)")
    B, H, _, dh = q.shape
    if k.shape[0] != B or v.shape[:3] != k.shape[:3] or k.shape[3] != dh:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if H % k.shape[1]:
        raise ValueError(f"{H} query heads do not group over "
                         f"{k.shape[1]} kv heads")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPES:
        raise ValueError(f"q, k, v must share one dtype of {list(_DTYPES)}; "
                         f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if dh > _MAX_DQK or v.shape[3] > _MAX_DV:
        raise ValueError(f"q/k head dims above {_MAX_DQK} and v head dims "
                         f"above {_MAX_DV} are not supported")
    if any(t.stride(3) != 1 for t in (q, k, v)):
        raise ValueError("the last dim of q, k and v must be contiguous")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must lie on one device")


def attend(q, k, v, *, scale: float, causal: bool = True, window: int = 0,
           softcap: float = 0.0):
    """q (B,H,Tq,dh), k (B,Hk,Tk,dh), v (B,Hk,Tk,dv) → (B,H,Tq,dv) in q's
    dtype. Inputs may be strided views; the output of the kernel has the
    memory order of q (a head-transposed q gives a head-transposed out)."""
    global launches
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, scale=scale, causal=causal,
                                       window=window, softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"flash attention runs on cuda or cpu, not "
                         f"{q.device}")
    _check(q, k, v)
    B, H, Tq, dh = q.shape
    Hk, Tk, dv = k.shape[1], k.shape[2], v.shape[3]
    if q.stride(1) < q.stride(2):       # (B, T, H, d) memory order
        out = q.new_empty((B, Tq, H, dv)).permute(0, 2, 1, 3)
    else:
        out = q.new_empty((B, H, Tq, dv))
    lib = _lib()
    err = lib.flash_attention_fwd(
        q.device.index or 0, _DTYPES[q.dtype], _build.ptr(q), _build.ptr(k),
        _build.ptr(v), _build.ptr(out),
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
        B, H, Hk, Tq, Tk, dh, dv, float(scale), int(bool(causal)),
        int(window), float(softcap), _build.stream(q.device))
    _build.check(lib, err, "flash_attention_fwd")
    launches += 1
    return out
