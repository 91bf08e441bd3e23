"""Public Mamba-1 selective scan, the prefill's and training's state
recurrence.

On CUDA tensors it launches hand-written kernels
(``kernels/csrc/selective_scan.cu``) or raises; the plain versions in
``ref.py`` run only for tensors on the CPU. No TPU kernel computes this:
JAX runs it as an ``associative_scan`` inside a ``lax.scan`` over chunks
(``repro/models/mamba.py::mamba1_mixer``) and differentiates that. The
forward kernel keeps each channel's state in the registers of
``flanes(N)`` lanes and walks the steps in order, one ``ex2`` a state entry and step,
its inputs brought in by a ring of ``cp.async`` tiles; ``chunk`` (the
plain version's chunking, JAX's) does not change what it computes. When
an input wants a gradient, :func:`selective_scan` runs
:class:`SelectiveScan`: the forward also saves the state entering each
tile of ``TS`` steps, and the backward kernel walks the tiles from last to
first, recomputing each tile's states and decays from the saved state by
the forward's code and keeping them in registers for the reverse walk.
``launches`` counts forward launches, ``bwd_launches`` backward calls
(each the reverse walk and the sum of its partials); a CUDA graph replay
adds what its capture recorded (``serve/graphs.py``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, _launches
from repro_torch.kernels.selective_scan import ref

launches = 0
bwd_launches = 0

# csrc/selective_scan.cu: N is a multiple of NMUL up to N_MAX; steps of a
# tile (the forward saves the state entering each); the forward's threads
# of a block and tiles in flight; the backward's lanes of a pair of
# channels, channels of a block (it writes one dB and dC partial per
# block) and intervals' inputs in shared memory
NMUL, N_MAX, TS = 8, 64, ref.TILE
FTHREADS, FSTAGES = 128, 4
BLANES, BCPB, BBUF = 8, 64, 3
SMEM_LIMIT = 232448        # bytes of shared memory a block may use (H100)


def flanes(N: int) -> int:
    """The forward's lanes of one channel at state width N, each holding
    N / flanes(N) entries (csrc ``flanes``)."""
    return 2 if N <= 32 else 4


def fcpb(N: int) -> int:
    """The forward's channels of a block at state width N."""
    return FTHREADS // flanes(N)


def fwd_smem_bytes(N: int) -> int:
    """The forward's dynamic shared memory at state width N: its ring of
    x, dt, B and C tiles and two y tiles (csrc ``fwd_smem_bytes``)."""
    return 4 * (FSTAGES * (2 * TS * fcpb(N) + 2 * TS * N) + 2 * TS * fcpb(N))


def sub_steps(entries: int) -> int:
    """Steps whose states and decays a backward lane holding ``entries``
    state entries keeps in registers (csrc ``sub_steps``): the whole
    interval up to 4 entries, then a half, a quarter, an eighth."""
    return TS if entries <= 4 else TS // 2 if entries <= 6 else \
        TS // 4 if entries <= 10 else TS // 8


def bwd_smem_bytes(N: int) -> int:
    """The backward's dynamic shared memory at state width N: ``BBUF``
    buffers of an interval's inputs and saved states, two each of its dx
    and ddt and of a sub-tile's dB and dC terms, a pair of channels a row
    (csrc ``bwd_smem_bytes``)."""
    inputs = 3 * TS * BCPB + 2 * TS * N + BCPB * N
    return 4 * (BBUF * inputs + 4 * TS * BCPB +
                2 * sub_steps(2 * N // BLANES) * BCPB * N)

_I, _P = ctypes.c_int, ctypes.c_void_p


def _lib() -> ctypes.CDLL:
    lib = _build.load("selective_scan")
    lib.selective_scan.argtypes = [_I, *[_P] * 9, _I, _I, _I, _I, _P]
    lib.selective_scan.restype = ctypes.c_int
    lib.selective_scan_bwd.argtypes = [_I, *[_P] * 17, _I, _I, _I, _I, _P]
    lib.selective_scan_bwd.restype = ctypes.c_int
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
    if N % NMUL or not NMUL <= N <= N_MAX:
        raise ValueError(f"the selective scan kernel takes a state of a "
                         f"multiple of {NMUL} up to {N_MAX}, not {N}")


def _aligned(t):
    """``t``, or a copy of it where its data is not 16-byte aligned (the
    kernels' vector loads and cp.async copies want it)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _on_card(x) -> bool:
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"the selective scan runs on cuda or cpu, not "
                         f"{x.device}")
    return True


def scan_forward(x, dt, A, Bm, Cm, h0, chunk: int, save: bool = False):
    """The forward alone → (y, h_last), and with ``save`` also hs (B,
    ceil(S / TS), C, N) f32, the state entering each tile of TS steps (the
    backward's checkpoints)."""
    if not _on_card(x):
        return ref.selective_scan_ref(x, dt, A, Bm, Cm, h0, chunk,
                                      tile=TS if save else 0)
    _check(x, dt, A, Bm, Cm, h0)
    x, dt, A, Bm, Cm, h0 = map(_aligned, (x, dt, A, Bm, Cm, h0))
    B, S, C = x.shape
    N = A.shape[-1]
    y = torch.empty_like(x)
    h_last = torch.empty_like(h0)
    hs = torch.empty((B, -(-S // TS), C, N), dtype=torch.float32,
                     device=x.device) if save else None
    if y.numel() == 0:
        h_last.copy_(h0)
        return (y, h_last, hs) if save else (y, h_last)
    lib = _lib()
    err = lib.selective_scan(
        x.device.index or 0, *(_build.ptr(t) for t in
                               (x, dt, A, Bm, Cm, h0, y, h_last)),
        None if hs is None else _build.ptr(hs), B, S, C, N,
        _build.stream(x.device))
    _build.check(lib, err, "selective_scan")
    _launches.bump(__name__, "launches")
    return (y, h_last, hs) if save else (y, h_last)


def selective_scan_bwd(x, dt, A, Bm, Cm, hs, dy, dh_last):
    """Gradients of the scan from its inputs, the states hs that
    :func:`scan_forward` saved and the cotangents dy (B,S,C) and dh_last
    (B,C,N) → (dx, ddt (B,S,C), dA (C,N), dB, dC (B,S,N), dh0 (B,C,N)) f32.
    dA sums over the batch, dB and dC over the channels, in a fixed order
    (two calls give the same bits)."""
    if not _on_card(x):
        return ref.selective_scan_bwd_ref(x, dt, A, Bm, Cm, hs, dy, dh_last,
                                          tile=TS)
    dy, dh_last = dy.contiguous(), dh_last.contiguous()
    _check(x, dt, A, Bm, Cm, dh_last)
    B, S, C = x.shape
    N = A.shape[-1]
    K = -(-S // TS)
    if hs.shape != (B, K, C, N) or hs.dtype != torch.float32 or \
            not hs.is_contiguous() or hs.device != x.device:
        raise ValueError(f"hs must be a contiguous f32 (B, ceil(S/{TS}), C, "
                         f"N) = {(B, K, C, N)} on {x.device}, not "
                         f"{tuple(hs.shape)} {hs.dtype}")
    if dy.shape != x.shape or dy.dtype != torch.float32 or \
            dy.device != x.device:
        raise ValueError(f"dy must be f32 {tuple(x.shape)} on {x.device}")
    x, dt, A, Bm, Cm, hs, dy, dh_last = map(_aligned, (
        x, dt, A, Bm, Cm, hs, dy, dh_last))
    f32 = dict(dtype=torch.float32, device=x.device)
    dx, ddt = torch.empty_like(x), torch.empty_like(x)
    dA = torch.empty((C, N), **f32)
    dB, dC = torch.empty((B, S, N), **f32), torch.empty((B, S, N), **f32)
    dh0 = torch.empty((B, C, N), **f32)
    if x.numel() == 0:
        return dx, ddt, dA.zero_(), dB.zero_(), dC.zero_(), dh0.copy_(dh_last)
    ncb = -(-C // BCPB)
    dA_part = torch.empty((B, C, N), **f32)
    dB_part = torch.empty((B, ncb, S, N), **f32)
    dC_part = torch.empty((B, ncb, S, N), **f32)
    lib = _lib()
    err = lib.selective_scan_bwd(
        x.device.index or 0, *(_build.ptr(t) for t in (
            x, dt, A, Bm, Cm, hs, dy, dh_last, dx, ddt, dA_part, dB_part,
            dC_part, dA, dB, dC, dh0)),
        B, S, C, N, _build.stream(x.device))
    _build.check(lib, err, "selective_scan_bwd")
    _launches.bump(__name__, "bwd_launches")
    return dx, ddt, dA, dB, dC, dh0


class SelectiveScan(torch.autograd.Function):
    """The scan with gradients: the forward saves the tile states (the
    forward kernel with hs on the card, the plain version's states on the
    CPU), the backward is :func:`selective_scan_bwd` (the backward kernel
    on the card, ``ref.selective_scan_bwd_ref`` on the CPU)."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, h0, chunk):
        y, h_last, hs = scan_forward(x, dt, A, Bm, Cm, h0, chunk, save=True)
        ctx.save_for_backward(x, dt, A, Bm, Cm, hs)
        return y, h_last

    @staticmethod
    def backward(ctx, dy, dh_last):
        grads = selective_scan_bwd(*ctx.saved_tensors, dy, dh_last)
        return (*(g if need else None for g, need in
                  zip(grads, ctx.needs_input_grad)), None)


def selective_scan(x, dt, A, Bm, Cm, h0, chunk: int):
    """x, dt (B,S,C), A (C,N) (negative), Bm, Cm (B,S,N), h0 (B,C,N), f32
    → y (B,S,C), h_last (B,C,N) f32: h_t = exp(dt_t·A)·h_{t-1} +
    (dt_t·x_t)·B_t from h0, and y_t = Σ_n h_t[:, n]·C_t[n]. Through
    :class:`SelectiveScan` when an input wants a gradient; else the forward
    alone, which saves nothing (serving)."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, dt, A, Bm, Cm, h0)):
        return SelectiveScan.apply(x, dt, A, Bm, Cm, h0, chunk)
    return scan_forward(x, dt, A, Bm, Cm, h0, chunk)
