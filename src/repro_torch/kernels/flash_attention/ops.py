"""Public flash-attention ops: the forward (serving), the forward that also
returns lse, and the backward (training).

On CUDA tensors they launch the hand-written kernels
(``kernels/csrc/flash_attention.cu``, ``flash_attention_bwd.cu``) or raise;
the plain versions in ``ref.py`` run only for tensors on the CPU. Each op
counts the calls that launched its kernels: ``launches`` (forward),
``lse_launches`` (forward with lse), ``bwd_launches`` (backward: delta, dq
pass and dk/dv pass). A CUDA graph's replay adds the counts its capture
recorded (``serve/graphs.py``), so they count launches on the card.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, _launches
from repro_torch.kernels.flash_attention import ref

launches = 0
lse_launches = 0
bwd_launches = 0

SMEM_LIMIT = 232448      # shared memory one block may opt into on an H100
# The wgmma forward's tiles (csrc/flash_attention.cu): query rows per work
# tile and keys per K/V tile (fwd_kn: 64 at dv 256); its ring has 3 stages
# where they fit, else 2
WQ, WK = 128, 128
_WGMMA_DIMS = frozenset([(64, 64), (80, 80), (128, 128), (192, 128),
                         (256, 256)])
# (dh, dv) computed by a larger wgmma instance, the head dim zero-filled by
# TMA: h2o-danube-1.8b's 80 on the (128, 128) instance
_WGMMA_PADDED = {(80, 80): (128, 128)}
_MMA_DIMS = frozenset([(16, 16), (32, 32)])
# the backward's mma.sync passes: (dqk, dv) of whisper, the GQA models and
# deepseek-v2's MLA
_BWD_MMA_DIMS = frozenset([(64, 64), (128, 128), (192, 128)])
_ROUTES = {"f32": 0, "mma": 1, "wgmma": 2}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_DQK = 256           # q/k head dim (MLA prefill: nope 128 + rope 64)
_MAX_DV = 256
_MAX_BWD = 256           # backward: q/k and v head dims
_I, _LL, _F, _P = ctypes.c_int, ctypes.c_longlong, ctypes.c_float, \
    ctypes.c_void_p
_FWD_ARGTYPES = [_I, _I, _I, _P, _P, _P, _P, _P, _P] + [_LL] * 12 + \
    [_I] * 7 + [_F, _I, _I, _F, _P]
_BWD_ARGTYPES = [_I, _I, _I] + [_P] * 10 + [_LL] * 24 + [_I] * 7 + \
    [_F, _I, _I, _F, _P]


def fwd_kn(dv: int) -> int:
    """Keys per K/V tile of the wgmma forward: WK, and 64 at dv 256, where
    the output accumulator alone takes 128 registers a thread."""
    return 64 if dv > 128 else WK


def wgmma_instance(dh: int, dv: int) -> tuple[int, int]:
    """The (DH, DV) instance of the wgmma forward that computes head dims
    (dh, dv): their own, or (128, 128) for dh = dv = 80."""
    return _WGMMA_PADDED.get((dh, dv), (dh, dv))


def _smem(dh: int, dv: int, stages: int) -> int:
    return 1024 + 2 * (WQ * dh + stages * fwd_kn(dv) * (dh + dv)) + \
        8 * (3 + 2 * stages)


def fwd_stages(dh: int, dv: int) -> int:
    """K/V tiles in flight in the wgmma forward's ring: 3 where they fit in
    the shared memory a block may use (dh <= 128), else 2 (MLA's 192, and
    256); of the instance that computes (dh, dv)."""
    dh, dv = wgmma_instance(dh, dv)
    return 3 if _smem(dh, dv, 3) <= SMEM_LIMIT else 2


def fwd_smem_bytes(dh: int, dv: int) -> int:
    """Shared memory of one block of the wgmma forward's instance for (dh,
    dv) (:func:`wgmma_instance`): Q (WQ x DH), a ring of ``fwd_stages`` K
    (kn x DH) and V (kn x DV) tiles in bf16 (kn = :func:`fwd_kn`), full and
    empty mbarriers for Q and for each stage, the work tile's index (8
    bytes), and 1024 bytes to align the tiles to the 128-byte swizzle's
    period (FwdSmem in csrc/flash_attention.cu)."""
    return _smem(*wgmma_instance(dh, dv), fwd_stages(dh, dv))


def fwd_route(dtype: torch.dtype, dh: int, dv: int, aligned: bool) -> str:
    """The forward's kernel for a call: "wgmma" (bf16, (dh, dv) of the
    served and trained models: 64, 80 (on the 128 instance), 128, 256 or
    MLA's (192, 128)), "mma" (bf16, dh = dv in {16, 32}: test-sized models)
    or "f32" (CUDA cores: f32, any other dims, or rows not 16-byte
    aligned). ``aligned``: every pointer and stride of q, k, v is a
    multiple of 8 elements."""
    if dtype != torch.bfloat16 or not aligned:
        return "f32"
    if (dh, dv) in _WGMMA_DIMS:
        return "wgmma"
    return "mma" if (dh, dv) in _MMA_DIMS else "f32"


def bwd_route(dtype: torch.dtype, dh: int, dv: int, aligned: bool) -> str:
    """The backward's kernels for a call: "mma" (bf16, (dh, dv) in {(64,
    64), (128, 128), (192, 128)}: ``mma.sync`` tensor-core passes) or "f32"
    (CUDA cores: f32, other dims, or rows not 16-byte aligned). ``aligned``:
    every pointer and stride of q, k, v, do and the three gradients is a
    multiple of 8 elements."""
    if dtype == torch.bfloat16 and aligned and (dh, dv) in _BWD_MMA_DIMS:
        return "mma"
    return "f32"


def _aligned(*ts) -> bool:
    return all(t.data_ptr() % 16 == 0 and
               all(s % 8 == 0 for s in t.stride()[:3]) for t in ts)


def _fwd_lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    lib.flash_attention_fwd.argtypes = _FWD_ARGTYPES
    lib.flash_attention_fwd.restype = ctypes.c_int
    return lib


def _bwd_lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention_bwd")
    lib.flash_attention_bwd.argtypes = _BWD_ARGTYPES
    lib.flash_attention_bwd.restype = ctypes.c_int
    return lib


def _check(q, k, v, max_dqk=_MAX_DQK, max_dv=_MAX_DV) -> None:
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
    if dh > max_dqk or v.shape[3] > max_dv:
        raise ValueError(f"q/k head dims above {max_dqk} and v head dims "
                         f"above {max_dv} are not supported")
    if any(t.stride(3) != 1 for t in (q, k, v)):
        raise ValueError("the last dim of q, k and v must be contiguous")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must lie on one device")


def _empty_like_order(x, shape):
    """An uninitialised (B, H, T, d) tensor in x's memory order: (B, T, H, d)
    memory for a head-transposed x, else contiguous."""
    B, H, T, d = shape
    if x.stride(1) < x.stride(2):
        return x.new_empty((B, T, H, d)).permute(0, 2, 1, 3)
    return x.new_empty((B, H, T, d))


def _on_card(q) -> bool:
    if q.device.type == "cpu":
        return False
    if q.device.type != "cuda":
        raise ValueError(f"flash attention runs on cuda or cpu, not "
                         f"{q.device}")
    return True


def _fwd(q, k, v, lse, scale, causal, window, softcap):
    B, H, Tq, _ = q.shape
    route = fwd_route(q.dtype, q.shape[3], v.shape[3], _aligned(q, k, v))
    out = _empty_like_order(q, (B, H, Tq, v.shape[3]))
    # the wgmma path's blocks claim work tiles from this counter
    counter = torch.zeros(1, dtype=torch.int32, device=q.device) \
        if route == "wgmma" else None
    lib = _fwd_lib()
    err = lib.flash_attention_fwd(
        q.device.index or 0, _DTYPES[q.dtype], _ROUTES[route],
        _build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(out),
        None if lse is None else _build.ptr(lse),
        None if counter is None else _build.ptr(counter),
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
        B, H, k.shape[1], Tq, k.shape[2], q.shape[3], v.shape[3],
        float(scale), int(bool(causal)), int(window), float(softcap),
        _build.stream(q.device))
    _build.check(lib, err, "flash_attention_fwd")
    return out


def attend(q, k, v, *, scale: float, causal: bool = True, window: int = 0,
           softcap: float = 0.0):
    """q (B,H,Tq,dh), k (B,Hk,Tk,dh), v (B,Hk,Tk,dv) → (B,H,Tq,dv) in q's
    dtype. Inputs may be strided views; the output of the kernel has the
    memory order of q (a head-transposed q gives a head-transposed out)."""
    if not _on_card(q):
        return ref.flash_attention_ref(q, k, v, scale=scale, causal=causal,
                                       window=window, softcap=softcap)
    _check(q, k, v)
    out = _fwd(q, k, v, None, scale, causal, window, softcap)
    _launches.bump(__name__, "launches")
    return out


def attend_fwd_lse(q, k, v, *, scale: float, causal: bool = True,
                   window: int = 0, softcap: float = 0.0):
    """As :func:`attend`, and also lse (B,H,Tq) f32: the residual of
    :func:`attend_bwd` (0 + log 1e-30 for a row with no live key)."""
    if not _on_card(q):
        return ref.flash_attention_fwd_lse_ref(
            q, k, v, scale=scale, causal=causal, window=window,
            softcap=softcap)
    _check(q, k, v)
    B, H, Tq, _ = q.shape
    lse = torch.empty((B, H, Tq), dtype=torch.float32, device=q.device)
    out = _fwd(q, k, v, lse, scale, causal, window, softcap)
    _launches.bump(__name__, "lse_launches")
    return out, lse


def attend_bwd(q, k, v, o, lse, do, *, scale: float, causal: bool = True,
               window: int = 0, softcap: float = 0.0):
    """Gradients of :func:`attend` given its output ``o``, ``lse`` from
    :func:`attend_fwd_lse` and the output's cotangent ``do`` (B,H,Tq,dv).
    → (dq, dk, dv) shaped and typed as q, k, v (dk and dv with Hk heads,
    summed over each group), each in the memory order of its input."""
    if not _on_card(q):
        return ref.flash_attention_bwd_ref(q, k, v, o, lse, do, scale=scale,
                                           causal=causal, window=window,
                                           softcap=softcap)
    _check(q, k, v, _MAX_BWD, _MAX_BWD)
    B, H, Tq, dh = q.shape
    dv_dim = v.shape[3]
    for name, t in (("o", o), ("do", do)):
        if t.shape != (B, H, Tq, dv_dim) or t.dtype != q.dtype or \
                t.device != q.device or t.stride(3) != 1:
            raise ValueError(f"{name} must be ({B}, {H}, {Tq}, {dv_dim}) "
                             f"{q.dtype} on {q.device} with a contiguous "
                             f"last dim; got {tuple(t.shape)} {t.dtype}")
    if lse.shape != (B, H, Tq) or lse.dtype != torch.float32 or \
            not lse.is_contiguous() or lse.device != q.device:
        raise ValueError(f"lse must be a contiguous ({B}, {H}, {Tq}) float32 "
                         f"tensor on {q.device}")
    dq = _empty_like_order(q, q.shape)
    dk = _empty_like_order(k, k.shape)
    dv = _empty_like_order(v, v.shape)
    delta = torch.empty((B, H, Tq), dtype=torch.float32, device=q.device)
    route = bwd_route(q.dtype, dh, dv_dim, _aligned(q, k, v, do, dq, dk, dv))
    lib = _bwd_lib()
    err = lib.flash_attention_bwd(
        q.device.index or 0, _DTYPES[q.dtype], _ROUTES[route],
        *(_build.ptr(t) for t in (q, k, v, o, do, lse, delta, dq, dk, dv)),
        *(s for t in (q, k, v, o, do, dq, dk, dv) for s in t.stride()[:3]),
        B, H, k.shape[1], Tq, k.shape[2], dh, dv_dim, float(scale),
        int(bool(causal)), int(window), float(softcap),
        _build.stream(q.device))
    _build.check(lib, err, f"flash_attention_bwd ({route})")
    _launches.bump(__name__, "bwd_launches")
    return dq, dk, dv
