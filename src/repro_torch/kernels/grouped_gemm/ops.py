"""Public grouped-GEMM op, the MoE expert product.

On CUDA tensors it launches the hand-written kernel
(``kernels/csrc/grouped_gemm.cu``) or raises; the plain version in
``ref.py`` runs only for tensors on the CPU. ``a`` may be a strided view
(stride 0 over experts: decode passes its tokens broadcast to every expert
without a copy); ``w`` is contiguous. ``launches`` counts kernel launches,
those of CUDA graph replays too: ``serve/graphs.py`` records the count's
change during a capture (taking it back: a capture launches nothing) and
adds it at every replay. ``route_launches`` counts the wrapper's calls by
route (:func:`route`), a capture's too and a replay's not.

:class:`GroupedGemm` is the product under autograd: its backward takes
dA = dC·Wᵀ and dW = Aᵀ·dC per expert through the same kernel (two more
launches a product), with Wᵀ and Aᵀ as contiguous copies.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, _launches
from repro_torch.kernels.grouped_gemm import ref

launches = 0
route_launches = {"f32": 0, "prefill": 0, "decode": 0}

SMEM_LIMIT = 232448      # shared memory one block may opt into on an H100
# The bf16 paths' tiles (csrc/grouped_gemm.cu): rows x columns of out per
# block, the K step and the stages of the TMA ring
TILES = {"prefill": (128, 256, 64, 4), "decode": (16, 128, 64, 4)}
DECODE_M = 16            # the decode path takes M up to its 16 token rows
_ROUTES = {"f32": 0, "prefill": 1, "decode": 2}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_I, _LL, _P = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
_ARGTYPES = [_I, _I, _I, _P, _P, _P, _LL, _LL, _I, _I, _I, _I, _P]


def route(dtype: torch.dtype, M: int) -> str:
    """The kernel for a call: "f32" (CUDA cores), or in bf16 "decode" (M <=
    16: a deep ring of w tiles, out^T = w^T a^T) or "prefill" (M > 16)."""
    if dtype != torch.bfloat16:
        return "f32"
    return "decode" if M <= DECODE_M else "prefill"


def smem_bytes(path: str) -> int:
    """Shared memory of one block of a bf16 path: a ring of (BM x BK) a and
    (BK x BN) w tiles in bf16, a full and an empty mbarrier per stage, and
    1024 bytes to align the tiles to the 128-byte swizzle's period (GgSmem
    in csrc/grouped_gemm.cu)."""
    bm, bn, bk, stages = TILES[path]
    return 1024 + stages * (2 * bk * (bm + bn) + 16)


def _lib() -> ctypes.CDLL:
    lib = _build.load("grouped_gemm")
    lib.grouped_gemm.argtypes = _ARGTYPES
    lib.grouped_gemm.restype = ctypes.c_int
    return lib


def _check(a, w) -> None:
    if a.dim() != 3 or w.dim() != 3:
        raise ValueError("grouped GEMM wants a (E, M, K) and w (E, K, N)")
    if a.shape[0] != w.shape[0] or a.shape[2] != w.shape[1]:
        raise ValueError(f"shape mismatch: a {tuple(a.shape)}, w "
                         f"{tuple(w.shape)}")
    if a.dtype != w.dtype or a.dtype not in _DTYPES:
        raise ValueError(f"a and w must share one dtype of {list(_DTYPES)}; "
                         f"got {a.dtype}, {w.dtype}")
    if a.device != w.device:
        raise ValueError("a and w must lie on one device")
    if not w.is_contiguous() or a.stride(2) != 1:
        raise ValueError("w must be contiguous and a's last dim contiguous")
    if a.dtype == torch.bfloat16:
        # 16-byte vector loads along K of a and along N of w (the stride of
        # a dim of size 1 is never used)
        E, M, K = a.shape
        N = w.shape[2]
        if K == 0 or K % 8 or N % 8 or (E > 1 and a.stride(0) % 8) or \
                (M > 1 and a.stride(1) % 8) or a.data_ptr() % 16 or \
                w.data_ptr() % 16:
            raise ValueError("bf16 grouped GEMM wants K > 0, K and N "
                             "multiples of 8 and 16-byte aligned rows")


def grouped_gemm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a (E, M, K) @ w (E, K, N) → (E, M, N) in a's dtype, f32 sums."""
    if a.device.type == "cpu":
        return ref.grouped_gemm_ref(a, w)
    if a.device.type != "cuda":
        raise ValueError(f"grouped GEMM runs on cuda or cpu, not {a.device}")
    _check(a, w)
    E, M, K = a.shape
    N = w.shape[2]
    out = torch.empty((E, M, N), dtype=a.dtype, device=a.device)
    if out.numel() == 0:
        return out
    lib = _lib()
    path = route(a.dtype, M)
    err = lib.grouped_gemm(
        a.device.index or 0, _DTYPES[a.dtype], _ROUTES[path],
        _build.ptr(a), _build.ptr(w),
        _build.ptr(out), a.stride(0), a.stride(1), E, M, K, N,
        _build.stream(a.device))
    _build.check(lib, err, "grouped_gemm")
    _launches.bump(__name__, "launches")
    with _launches.lock:
        route_launches[path] += 1
    return out


def _pad_rows(x: torch.Tensor, rows: int) -> torch.Tensor:
    """x (E, M, N) with zero rows appended up to ``rows``."""
    if x.shape[1] == rows:
        return x
    return torch.cat([x, x.new_zeros((x.shape[0], rows - x.shape[1],
                                      x.shape[2]))], dim=1)


class GroupedGemm(torch.autograd.Function):
    """:func:`grouped_gemm` with its gradients, each a grouped GEMM on the
    kernel: dA (E, M, K) = dC · Wᵀ and dW (E, K, N) = Aᵀ · dC, the
    transposed operands as contiguous copies. In dW the sum runs over the
    M rows (an expert's capacity); for bf16, whose kernel takes sums of a
    multiple of 8, Aᵀ gets zero columns and dC zero rows up to one, which
    adds nothing."""

    @staticmethod
    def forward(ctx, a, w):
        ctx.save_for_backward(a, w)
        return grouped_gemm(a, w)

    @staticmethod
    def backward(ctx, dc):
        a, w = ctx.saved_tensors
        dc = dc.contiguous()
        da = dw = None
        if ctx.needs_input_grad[0]:
            da = grouped_gemm(dc, w.transpose(1, 2).contiguous())
        if ctx.needs_input_grad[1]:
            M = a.shape[1]
            rows = -(-M // 8) * 8 if a.dtype == torch.bfloat16 else M
            at = _pad_rows(a, rows).transpose(1, 2).contiguous()
            dw = grouped_gemm(at, _pad_rows(dc, rows))
        return da, dw


def grouped_gemm_autograd(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """:func:`grouped_gemm`, through :class:`GroupedGemm` when an operand
    wants a gradient."""
    if torch.is_grad_enabled() and (a.requires_grad or w.requires_grad):
        return GroupedGemm.apply(a, w)
    return grouped_gemm(a, w)
