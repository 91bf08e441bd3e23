"""Public SSD intra-chunk op, the Mamba-2 prefill's quadratic part.

On CUDA tensors it launches a hand-written kernel (``kernels/csrc/ssd.cu``)
or raises; the plain version in ``ref.py`` runs only for tensors on the
CPU. Operands are f32 views with a contiguous last dim, read through their
strides: ``ssd_scan`` passes its activations as they lie and B and C with
stride 0 over heads. The kernel's outputs are views whose memory is the
scan's layout — y ``(G, Q, H, P)``, the state ``(G, H, P, N)`` — so the
scan neither copies nor transposes them.

Two kernels, one launch a call, chosen by :func:`ssd_route`, a pure function
of the shape: "mma" (``ssd_mma``: f32 products as three TF32 tensor-core
products, the scores computed once per chunk row for a group of heads when B
and C are shared, sized by :func:`ssd_plan`) for P ≤ 64 and N ≤ 128,
multiples of 8, on 16-byte aligned rows (mamba2: P 64, N 128), and "f32"
(``ssd_intra``: the CUDA cores) for everything else. ``launches`` counts
calls that launched a kernel, ``route_launches`` the same by route. A
CUDA graph's replay adds to ``launches`` what its capture recorded
(``serve/graphs.py``); ``route_launches`` counts eager calls only.

:class:`SsdIntraChunk` is the op under autograd: the kernel forward and a
backward through the plain version, recomputed (no TPU kernel computes
this backward; JAX differentiates the einsums of its ``ssd_scan``).
"""
from __future__ import annotations

import ctypes
import functools
import heapq
from typing import NamedTuple

import torch

from repro_torch.kernels import _build, _launches
from repro_torch.kernels.ssd import ref

launches = 0
route_launches = {"mma": 0, "f32": 0}

# ssd_mma (csrc/ssd.cu): rows t of a y block and keys of a key tile; the
# widest P and N it takes; keys of a state block's step; the most heads of a
# y block and of a state block; one block on each of an H100's SMs
MT, MP, MN, SK = 64, 64, 128, 32
HPB_MAX, HS_MAX = 4, 2
SMS = 132

_I, _P = ctypes.c_int, ctypes.c_void_p
_Strides = ctypes.c_longlong * 19


def ssd_route(P: int, N: int, aligned: bool) -> str:
    """The kernel for a call: "mma" (tensor cores) for P ≤ 64 and N ≤ 128,
    both multiples of 8, where ``aligned`` (x, B and C 16-byte aligned with
    (g, h, t) strides of multiples of 4 elements); "f32" (CUDA cores) for
    everything else."""
    fits = P % 8 == 0 and 8 <= P <= MP and N % 8 == 0 and 8 <= N <= MN
    return "mma" if fits and aligned else "f32"


class SsdPlan(NamedTuple):
    hpb: int         # heads of a y block (they share its scores)
    hs: int          # heads of a state block (they share its B)
    state_pos: int   # y classes (by t tile, last first) before the state's
    blocks: int


def _costs(G, H, Q, N, hpb, hs):
    """Steps of every block class of a plan, each step 96 mma.sync a warp:
    the y blocks of t tile i, (i + 1) key tiles of ceil(N / 64) B half
    tiles and an x step of hpb heads (one step a head: 2 warps a head, so
    each SM sub-partition's share grows with the heads); the state blocks,
    ceil(Q / 32) steps for each of hs heads. Returns ([(steps, blocks)] of
    the y classes, last t tile first, (steps, blocks) of the state)."""
    nt, nh = -(-Q // MT), -(-N // 64)
    ys = [((i + 1) * (nh + hpb), G * (H // hpb)) for i in reversed(range(nt))]
    return ys, (-(-Q // SK) * hs, G * (H // hs))


def _makespan(steps) -> int:
    """Steps until the last block ends when the blocks, in grid order, each
    take the first SM to come free, one block an SM."""
    free = [0] * SMS
    for n in steps:
        heapq.heappush(free, heapq.heappop(free) + n)
    return max(free)


@functools.lru_cache(maxsize=None)
def ssd_plan(G: int, H: int, Q: int, N: int, shared_bc: bool) -> SsdPlan:
    """Heads per y and state block for ssd_mma, from the shape alone.

    More heads a y block computes the scores fewer times (once per head
    group, not per head) but makes fewer, longer blocks. Each candidate —
    hpb and hs divisors of H up to HPB_MAX and HS_MAX; 1 and 1 unless B and
    C are shared by the heads (``shared_bc``) — has its grid run longest
    class first (``state_pos``: the y classes longer than the state blocks
    go before them) and is scored by the makespan of that order over SMS
    SMs (:func:`_makespan`); the least wins, ties going to fewer steps, then
    more heads. On an H100 this model ranked the plans timed at 8 chunk
    rows (Q 256), 2 and 1 (Q 97) as they ran (PERF.md §6)."""
    divs = [d for d in range(1, H + 1) if H % d == 0]
    hpbs = [d for d in divs if d <= HPB_MAX] if shared_bc else [1]
    hss = [d for d in divs if d <= HS_MAX] if shared_bc else [1]
    best = None
    for hpb in hpbs:
        for hs in hss:
            ys, (s_steps, s_blocks) = _costs(G, H, Q, N, hpb, hs)
            pos = sum(c > s_steps for c, _ in ys)
            order = [c for c, n in ys[:pos] for _ in range(n)] + \
                [s_steps] * s_blocks + \
                [c for c, n in ys[pos:] for _ in range(n)]
            key = (_makespan(order), sum(order), -hpb, -hs)
            if best is None or key < best[0]:
                best = (key, SsdPlan(hpb, hs, pos, len(order)))
    return best[1]


def _lib() -> ctypes.CDLL:
    lib = _build.load("ssd")
    lib.ssd_intra_chunk.argtypes = [_I, _P, _P, _P, _P, _P, _P, _Strides, _I,
                                    _I, _I, _I, _I, _P]
    lib.ssd_intra_chunk.restype = ctypes.c_int
    lib.ssd_intra_chunk_mma.argtypes = [_I, _P, _P, _P, _P, _P, _P, _Strides,
                                        _I, _I, _I, _I, _I, _I, _I, _I, _P]
    lib.ssd_intra_chunk_mma.restype = ctypes.c_int
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


def _aligned(*ts) -> bool:
    return all(t.data_ptr() % 16 == 0 and
               all(s % 4 == 0 for s in t.stride()[:3]) for t in ts)


def route_of(x, B, C) -> str:
    """:func:`ssd_route` of a call's operands."""
    return ssd_route(x.shape[-1], B.shape[-1], _aligned(x, B, C))


def plan_of(x, B, C) -> SsdPlan:
    """:func:`ssd_plan` of a call's operands."""
    G, H, Q, _ = x.shape
    return ssd_plan(G, H, Q, B.shape[-1],
                    B.stride(1) == 0 and C.stride(1) == 0)


def intra_chunk(x, cs, B, C):
    """x (G,H,Q,P), cs (G,H,Q), B/C (G,H,Q,N) f32 → y (G,H,Q,P), states
    (G,H,N,P) f32: y = ((C Bᵀ) ⊙ L) x and st = (B ⊙ exp(cs[-1] − cs))ᵀ x
    per (g, h), with L[t,s] = exp(cs[t] − cs[s]) for t ≥ s, else 0."""
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
    args = (x.device.index or 0, _build.ptr(x), _build.ptr(cs),
            _build.ptr(B), _build.ptr(C), _build.ptr(y), _build.ptr(st),
            strides, G, H, Q, P, N)
    route = route_of(x, B, C)
    if route == "mma":
        plan = plan_of(x, B, C)
        err = lib.ssd_intra_chunk_mma(*args, plan.hpb, plan.hs,
                                      plan.state_pos, _build.stream(x.device))
    else:
        err = lib.ssd_intra_chunk(*args, _build.stream(x.device))
    _build.check(lib, err, f"ssd_intra_chunk ({route})")
    _launches.bump(__name__, "launches")
    with _launches.lock:
        route_launches[route] += 1
    return y, st


class SsdIntraChunk(torch.autograd.Function):
    """:func:`intra_chunk` with gradients: the forward launches the kernel
    (on the card), the backward recomputes ``ref.ssd_intra_chunk_ref``
    under autograd and differentiates it. Gradients come back shaped as the
    inputs, per head: for B and C given with stride 0 over the heads,
    autograd's expand then sums them over the heads."""

    @staticmethod
    def forward(ctx, x, cs, B, C):
        ctx.save_for_backward(x, cs, B, C)
        return intra_chunk(x, cs, B, C)

    @staticmethod
    def backward(ctx, dy, dst):
        ins = [t.detach().requires_grad_(need) for t, need in
               zip(ctx.saved_tensors, ctx.needs_input_grad)]
        wants = [t for t in ins if t.requires_grad]
        with torch.enable_grad():
            outs = ref.ssd_intra_chunk_ref(*ins)
            pairs = [(o, g) for o, g in zip(outs, (dy, dst)) if g is not None]
            got = iter(torch.autograd.grad([o for o, _ in pairs],
                                           wants, [g for _, g in pairs]))
        return tuple(next(got) if t.requires_grad else None for t in ins)


def intra_chunk_autograd(x, cs, B, C):
    """:func:`intra_chunk`, through :class:`SsdIntraChunk` when an input
    wants a gradient."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in
                                       (x, cs, B, C)):
        return SsdIntraChunk.apply(x, cs, B, C)
    return intra_chunk(x, cs, B, C)
