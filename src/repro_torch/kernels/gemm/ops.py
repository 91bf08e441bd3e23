"""Public GEMM op — the paper's §4 tiled GEMM — and the HBB row split.

On CUDA tensors :func:`gemm` launches the hand-written kernel
(``kernels/csrc/gemm.cu``) or raises; the plain version in ``ref.py`` runs
only for tensors on the CPU. ``(bm, bn, bk)`` is a real launch shape, one
of :data:`SHAPES`, and must fit the card's shared memory by
:func:`smem_bytes` on either device: a shape over the law raises, it is
never clamped. ``a`` may be a row slice of a larger matrix (a view with a
row stride); ``b`` is contiguous. ``launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.gemm import ref

launches = 0

# Shared memory one block may opt into on an H100 (227 KiB)
SMEM_LIMIT = 232448
# The block shapes csrc/gemm.cu compiles (its GEMM_SHAPES): the default
# and the Table 2 sweep of bn ("buffered columns") at bm = 64, bk = 32
SHAPES = frozenset([(64, bn, 32) for bn in (32, 64, 128, 256)]
                   + [(128, 128, 32)])
# Defaults by the law: 128 x 128 output tiles give 256 threads 64
# accumulators each, and bk = 32 keeps the tiles at 18.5 KiB (bf16) or
# 33 KiB (f32), so several blocks share an SM
BM, BN, BK = 128, 128, 32

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_I, _LL, _P = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p


def smem_bytes(bm: int, bn: int, bk: int, itemsize: int = 2) -> int:
    """Shared memory of one block (the capacity law, the counterpart of
    ``vmem_bytes``): the A and B tiles of one K step, the accumulator in
    registers. 16-bit tiles are stored row-major with 8 elements of padding
    per row, 32-bit tiles K-major with 4."""
    if itemsize == 2:
        return (bm * (bk + 8) + bk * (bn + 8)) * 2
    return (bk * (bm + 4) + bk * (bn + 4)) * itemsize


def _check_block_shape(bm: int, bn: int, bk: int, dtype: torch.dtype) -> None:
    if dtype not in _DTYPES:
        raise ValueError(f"GEMM runs in {list(_DTYPES)}, not {dtype}")
    need = smem_bytes(bm, bn, bk, torch.empty((), dtype=dtype).element_size())
    if need > SMEM_LIMIT:
        raise ValueError(
            f"block shape (bm, bn, bk) = {(bm, bn, bk)} needs {need} bytes of "
            f"shared memory in {dtype}, over the {SMEM_LIMIT} one block may "
            "use")
    if (bm, bn, bk) not in SHAPES:
        raise ValueError(f"block shape {(bm, bn, bk)} is not compiled; have "
                         f"{sorted(SHAPES)}")


def _lib() -> ctypes.CDLL:
    lib = _build.load("gemm")
    lib.gemm.argtypes = [_I, _I, _P, _P, _P, _LL, _I, _I, _I, _I, _I, _I, _P]
    lib.gemm.restype = ctypes.c_int
    lib.gemm_smem_bytes.argtypes = [_I, _I, _I, _I]
    lib.gemm_smem_bytes.restype = ctypes.c_int
    return lib


def _check(a, b) -> None:
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"GEMM wants a (M, K) and b (K, N); got "
                         f"{tuple(a.shape)}, {tuple(b.shape)}")
    if a.dtype != b.dtype:
        raise ValueError(f"a and b must share one dtype; got {a.dtype}, "
                         f"{b.dtype}")
    if a.device != b.device:
        raise ValueError("a and b must lie on one device")
    if not b.is_contiguous() or a.stride(1) != 1:
        raise ValueError("b must be contiguous and a's rows contiguous")
    if a.dtype == torch.bfloat16:
        K, N = b.shape
        # 16-byte vector loads along K of a and N of b
        if K % 8 or N % 8 or (a.shape[0] > 1 and a.stride(0) % 8) or \
                a.data_ptr() % 16 or b.data_ptr() % 16:
            raise ValueError("bf16 GEMM wants K and N multiples of 8 and "
                             "16-byte aligned rows")


def gemm(a: torch.Tensor, b: torch.Tensor, *, bm: int = BM, bn: int = BN,
         bk: int = BK) -> torch.Tensor:
    """a (M, K) @ b (K, N) → (M, N) in a's dtype, f32 sums, with (bm, bn)
    output tiles and K steps of bk. Any M; f32 any N and K, bf16 N and K
    multiples of 8."""
    global launches
    _check_block_shape(bm, bn, bk, a.dtype)
    if a.device.type == "cpu":
        return ref.gemm_ref(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"GEMM runs on cuda or cpu, not {a.device}")
    _check(a, b)
    M, K = a.shape
    N = b.shape[1]
    out = torch.empty((M, N), dtype=a.dtype, device=a.device)
    if out.numel() == 0:
        return out
    lib = _lib()
    err = lib.gemm(a.device.index or 0, _DTYPES[a.dtype], _build.ptr(a),
                   _build.ptr(b), _build.ptr(out), a.stride(0), M, K, N, bm,
                   bn, bk, _build.stream(a.device))
    _build.check(lib, err, "gemm")
    launches += 1
    return out


matmul = gemm       # the JAX package's name for the public op


def host_gemm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The core-class executor: the plain product computed on the host,
    returned on a's device (the host writing its rows of a shared C)."""
    return ref.gemm_ref(a.cpu(), b.cpu()).to(a.device)


def matmul_row_split(a, b, split: int, fast_fn=None, slow_fn=None):
    """Paper mode: rows [0, split) to the accelerator-class executor (the
    kernel), the rest to the core-class executor on the host (HBB decides
    ``split``). The result lies on a's device."""
    fast_fn = fast_fn or matmul
    slow_fn = slow_fn or host_gemm
    top = fast_fn(a[:split], b) if split else None
    bot = slow_fn(a[split:], b) if split < a.shape[0] else None
    if top is None:
        return bot
    if bot is None:
        return top
    return torch.cat([top, bot.to(top.device)], dim=0)
