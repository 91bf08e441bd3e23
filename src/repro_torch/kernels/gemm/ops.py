"""Public GEMM op — the paper's §4 tiled GEMM — and the HBB row split.

On CUDA tensors :func:`gemm` launches the hand-written kernel
(``kernels/csrc/gemm.cu``) or raises; the plain version in ``ref.py`` runs
only for tensors on the CPU. With no block shape, :func:`plan` picks the
output tile and the split of K from the shape; a block shape given
explicitly is launched as given, unsplit. ``(bm, bn, bk)`` is a real launch
shape, one of :data:`SHAPES`, and must fit the card's shared memory by
:func:`smem_bytes` on either device: a shape over the law raises, it is
never clamped. ``a`` may be a row slice of a larger matrix (a view with a
row stride); ``b`` is contiguous. ``launches`` counts calls that launched
the kernel (one per call, split or not); a CUDA graph's replay adds what its
capture recorded (``serve/graphs.py``).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build, _launches
from repro_torch.kernels.gemm import ref

launches = 0

# Shared memory one block may opt into on an H100 (227 KiB)
SMEM_LIMIT = 232448
# The block shapes csrc/gemm.cu compiles (its GEMM_SHAPES): the default,
# the Table 2 sweep of bn ("buffered columns") at bm = 64, bk = 32, and
# (32, 64, 32) for chunks of few rows
SHAPES = frozenset([(64, bn, 32) for bn in (32, 64, 128, 256)]
                   + [(128, 128, 32), (32, 64, 32)])
# The default block, and the bf16 path's: 128 x 128 output tiles give 256
# threads 64 accumulators each
BM, BN, BK = 128, 128, 32
# Stages of the f32 path's cp.async ring (gemm.cu's STAGES)
F32_STAGES = 3

# The plan (f32): output tiles from the largest down, each split over K
# until the grid fills the card
F32_TILES = ((128, 128, 32), (64, 128, 32), (64, 64, 32), (32, 64, 32))
# Blocks that fill an H100: one on each of 128 of its 132 SMs (a
# power-of-two split of a power-of-two grid lands on 128, not 132)
MIN_BLOCKS = 128
# The most splits a tile that can fill the card takes: the last block of a
# tile sums its partials alone, and past 4 partials of a large tile that
# sum costs more than the blocks gain (tools/gemm_plan_grid.py)
MAX_SPLITS = 4
# The least K one split walks: 4 steps of bk = 32, so the ring fills
MIN_SPLIT_K = 128

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_I, _LL, _P = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
# Split-K arrival counters, one per output tile, of each (device, stream):
# zero between calls (the last block of a tile to arrive wraps its counter
# back to 0), so they are made once and grown; kernels on one stream run in
# order, so that stream's calls share them
_counters: dict[tuple[int, int], torch.Tensor] = {}


def smem_bytes(bm: int, bn: int, bk: int, itemsize: int = 2) -> int:
    """Shared memory of one block (the capacity law, the counterpart of
    ``vmem_bytes``): the A and B tiles, the accumulator in registers.
    16-bit tiles: one K step, row-major with 8 elements of padding per row.
    32-bit tiles: a ring of ``F32_STAGES`` K steps, row-major with 4."""
    if itemsize == 2:
        return (bm * (bk + 8) + bk * (bn + 8)) * 2
    return F32_STAGES * (bm * (bk + 4) + bk * (bn + 4)) * itemsize


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _splits(tiles: int, K: int, most: int) -> int:
    """The fewest power-of-two splits, at most ``most`` and each walking at
    least MIN_SPLIT_K of K, that bring ``tiles`` to MIN_BLOCKS blocks (the
    most allowed if none does)."""
    splits = 1
    while tiles * splits < MIN_BLOCKS and 2 * splits <= most and \
            K // (2 * splits) >= MIN_SPLIT_K:
        splits *= 2
    return splits


@functools.lru_cache(maxsize=256)
def plan(M: int, N: int, K: int, dtype: torch.dtype
         ) -> tuple[int, int, int, int]:
    """``(bm, bn, bk, splits)`` for ``gemm`` of an (M, K) by (K, N) product.
    f32: the largest tile of :data:`F32_TILES` no taller than M whose grid
    reaches :data:`MIN_BLOCKS` blocks with K split in at most
    :data:`MAX_SPLITS` power-of-two slices of at least :data:`MIN_SPLIT_K`;
    if none does, the smallest tile with K split as far as needed and
    MIN_SPLIT_K allows (the grid stays short of MIN_BLOCKS only where K is
    too short to split further). bf16: the default block, unsplit."""
    if dtype != torch.float32:
        return BM, BN, BK, 1
    low = F32_TILES[-1]
    for bm, bn, bk in F32_TILES:
        if bm > max(M, low[0]):
            continue
        tiles = _cdiv(M, bm) * _cdiv(N, bn)
        splits = _splits(tiles, K, MAX_SPLITS)
        if tiles * splits >= MIN_BLOCKS:
            return bm, bn, bk, splits
    tiles = _cdiv(M, low[0]) * _cdiv(N, low[1])
    return (*low, _splits(tiles, K, max(1, K // MIN_SPLIT_K)))


def launch_shape(M: int, N: int, K: int, dtype: torch.dtype,
                 bm: int | None = None, bn: int | None = None,
                 bk: int | None = None) -> tuple[int, int, int, int]:
    """The ``(bm, bn, bk, splits)`` that :func:`gemm` launches: the plan when
    no block shape is given, else the given one (unset sizes from ``BM``,
    ``BN``, ``BK``) unsplit."""
    if bm is None and bn is None and bk is None:
        return plan(M, N, K, dtype)
    return bm or BM, bn or BN, bk or BK, 1


@functools.lru_cache(maxsize=64)
def _check_block_shape(bm: int, bn: int, bk: int, dtype: torch.dtype) -> None:
    if dtype not in _DTYPES:
        raise ValueError(f"GEMM runs in {list(_DTYPES)}, not {dtype}")
    need = smem_bytes(bm, bn, bk, dtype.itemsize)
    if need > SMEM_LIMIT:
        raise ValueError(
            f"block shape (bm, bn, bk) = {(bm, bn, bk)} needs {need} bytes of "
            f"shared memory in {dtype}, over the {SMEM_LIMIT} one block may "
            "use")
    if (bm, bn, bk) not in SHAPES:
        raise ValueError(f"block shape {(bm, bn, bk)} is not compiled; have "
                         f"{sorted(SHAPES)}")


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("gemm")
    lib.gemm.argtypes = [_I, _I, _P, _P, _P, _P, _P, _LL, _I, _I, _I, _I, _I,
                         _I, _I, _P]
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


def gemm(a: torch.Tensor, b: torch.Tensor, *, bm: int | None = None,
         bn: int | None = None, bk: int | None = None) -> torch.Tensor:
    """a (M, K) @ b (K, N) → (M, N) in a's dtype, f32 sums. With no block
    shape, tile and split of K follow :func:`plan`; ``(bm, bn, bk)`` given
    (unset ones default to ``BM``, ``BN``, ``BK``) is launched as given,
    unsplit. Any M; f32 any N and K, bf16 N and K multiples of 8."""
    M, K = a.shape[0], a.shape[-1]
    N = b.shape[-1]
    bm, bn, bk, splits = launch_shape(M, N, K, a.dtype, bm, bn, bk)
    _check_block_shape(bm, bn, bk, a.dtype)
    if not a.is_cuda:
        if a.device.type == "cpu":
            return ref.gemm_ref(a, b)
        raise ValueError(f"GEMM runs on cuda or cpu, not {a.device}")
    _check(a, b)
    out = _launch(a, b, bm, bn, bk, splits)
    if out.numel():
        _launches.bump(__name__, "launches")
    return out


def _launch(a: torch.Tensor, b: torch.Tensor, bm: int, bn: int, bk: int,
            splits: int) -> torch.Tensor:
    """One launch of the kernel on a's card at tile ``(bm, bn, bk)`` with K
    split ``splits`` ways, on operands :func:`gemm` has checked; none for
    an empty output. Not counted: :func:`gemm` counts its own launches."""
    M, K = a.shape
    N = b.shape[1]
    out = torch.empty((M, N), dtype=a.dtype, device=a.device)
    if out.numel() == 0:
        return out
    dev = a.device.index or 0
    stream = _build.stream(a.device)
    ws = cnt = None
    if splits > 1:
        ws = torch.empty((splits, M, N), dtype=torch.float32, device=a.device)
        tiles = _cdiv(M, bm) * _cdiv(N, bn)
        cnt = _counters.get((dev, stream))
        if cnt is None or cnt.numel() < tiles:
            cnt = torch.zeros(tiles, dtype=torch.int32, device=a.device)
            _counters[(dev, stream)] = cnt
    lib = _lib()
    err = lib.gemm(dev, _DTYPES[a.dtype], a.data_ptr(), b.data_ptr(),
                   out.data_ptr(), ws if ws is None else ws.data_ptr(),
                   cnt if cnt is None else cnt.data_ptr(), a.stride(0), M, K,
                   N, bm, bn, bk, splits, stream)
    _build.check(lib, err, "gemm")
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
