"""Public paged-attention decode ops: GQA and absorbed MLA.

On CUDA tensors they launch the hand-written kernels
(``kernels/csrc/paged_attention.cu``) or raise; the plain versions in
``ref.py`` run only for tensors on the CPU. Outputs are the unnormalized
``(o, m, l)`` softmax partials that the caller combines. ``launches``
counts GQA kernel launches, ``mla_launches`` MLA kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.paged_attention import ref

launches = 0
mla_launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_GROUP = 8
_MAX_DIM = 128
_I, _F, _P = ctypes.c_int, ctypes.c_float, ctypes.c_void_p
_ARGTYPES = [_I, _I] + [_P] * 8 + [_I] * 9 + [_F, _F, _P]
_MLA_ARGTYPES = [_I, _I] + [_P] * 10 + [_I] * 9 + [_F, _I, _I, _P]
_MLA_MAX_R = 1024
_MLA_MAX_LORA = 512
_MLA_CHUNK = 256         # keys per block: a slot's keys spread over blocks
_MLA_MAX_SPLITS = 64


def _lib() -> ctypes.CDLL:
    lib = _build.load("paged_attention")
    lib.paged_attention_gqa.argtypes = _ARGTYPES
    lib.paged_attention_gqa.restype = ctypes.c_int
    lib.paged_attention_mla.argtypes = _MLA_ARGTYPES
    lib.paged_attention_mla.restype = ctypes.c_int
    return lib


def _check(q, pool_k, pool_v, page_table, pos) -> None:
    if q.dim() != 4 or pool_k.dim() != 4:
        raise ValueError("paged decode wants q (B,Hkv,G,dh) and pools "
                         "(N,ps,Hkv,dh)")
    B, hkv, grp, dh = q.shape
    if pool_k.shape != pool_v.shape or pool_k.shape[2:] != (hkv, dh):
        raise ValueError(f"pool shapes {tuple(pool_k.shape)}, "
                         f"{tuple(pool_v.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if page_table.dim() != 2 or page_table.shape[0] != B or \
            tuple(pos.shape) != (B,):
        raise ValueError(f"page_table {tuple(page_table.shape)} / pos "
                         f"{tuple(pos.shape)} do not match batch {B}")
    if not (q.dtype == pool_k.dtype == pool_v.dtype) or \
            q.dtype not in _DTYPES:
        raise ValueError(f"q and pools must share one dtype of "
                         f"{list(_DTYPES)}")
    if page_table.dtype != torch.int32 or pos.dtype != torch.int32:
        raise ValueError("page_table and pos must be int32")
    if grp > _MAX_GROUP or dh > _MAX_DIM or dh % 8:
        raise ValueError(f"group {grp} (at most {_MAX_GROUP}) or head dim "
                         f"{dh} (a multiple of 8, at most {_MAX_DIM}) is not "
                         "supported")
    if pool_k.data_ptr() % 16 or pool_v.data_ptr() % 16:
        raise ValueError("the pools must be 16-byte aligned")
    ts = (q, pool_k, pool_v, page_table, pos)
    if any(not t.is_contiguous() for t in ts):
        raise ValueError("paged decode wants contiguous tensors")
    if any(t.device != q.device for t in ts):
        raise ValueError("paged decode inputs must lie on one device")


def paged_attend_gqa(q, pool_k, pool_v, page_table, pos, base: int = 0, *,
                     page_size: int, scale: float, softcap: float = 0.0):
    """q (B,Hkv,G,dh); pools (N, ps, Hkv, dh); page_table (B,T) int32; pos
    (B,) int32; ``base`` the global position of in-page offset 0 (shard
    offset; 0 on one device) → (o (B,Hkv·G,dh), m (B,Hkv·G), l (B,Hkv·G))
    f32 partials."""
    global launches
    if q.device.type == "cpu":
        return ref.paged_flash_decode_gqa_ref(
            q, pool_k, pool_v, page_table, pos, base, page_size=page_size,
            scale=scale, softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"paged decode runs on cuda or cpu, not {q.device}")
    _check(q, pool_k, pool_v, page_table, pos)
    B, hkv, grp, dh = q.shape
    N, ps = pool_k.shape[:2]
    o = torch.empty((B, hkv * grp, dh), dtype=torch.float32, device=q.device)
    m = torch.empty((B, hkv * grp), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    lib = _lib()
    err = lib.paged_attention_gqa(
        q.device.index or 0, _DTYPES[q.dtype], _build.ptr(q),
        _build.ptr(pool_k), _build.ptr(pool_v), _build.ptr(page_table),
        _build.ptr(pos), _build.ptr(o), _build.ptr(m), _build.ptr(l),
        B, hkv, grp, dh, N, ps, page_table.shape[1], int(page_size),
        int(base), float(scale), float(softcap), _build.stream(q.device))
    _build.check(lib, err, "paged_attention_gqa")
    launches += 1
    return o, m, l


def _check_mla(q, pool, page_table, pos, kv_lora: int) -> None:
    if q.dim() != 3 or pool.dim() != 3:
        raise ValueError("MLA paged decode wants q (B,H,R) and a pool "
                         "(N,ps,R)")
    B, H, R = q.shape
    if pool.shape[2] != R:
        raise ValueError(f"pool rows {pool.shape[2]} != query dim {R}")
    if page_table.dim() != 2 or page_table.shape[0] != B or \
            tuple(pos.shape) != (B,):
        raise ValueError(f"page_table {tuple(page_table.shape)} / pos "
                         f"{tuple(pos.shape)} do not match batch {B}")
    if q.dtype != pool.dtype or q.dtype not in _DTYPES:
        raise ValueError(f"q and pool must share one dtype of "
                         f"{list(_DTYPES)}")
    if page_table.dtype != torch.int32 or pos.dtype != torch.int32:
        raise ValueError("page_table and pos must be int32")
    if R % 8 or R > _MLA_MAX_R or not 0 < kv_lora <= min(R, _MLA_MAX_LORA):
        raise ValueError(f"row dim {R} (a multiple of 8, at most "
                         f"{_MLA_MAX_R}) or kv_lora {kv_lora} (at most "
                         f"{_MLA_MAX_LORA} and R) is not supported")
    if pool.data_ptr() % 16:
        raise ValueError("the pool must be 16-byte aligned")
    ts = (q, pool, page_table, pos)
    if any(not t.is_contiguous() for t in ts):
        raise ValueError("MLA paged decode wants contiguous tensors")
    if any(t.device != q.device for t in ts):
        raise ValueError("MLA paged decode inputs must lie on one device")


def paged_attend_mla(q, pool, page_table, pos, base: int = 0, *,
                     page_size: int, kv_lora: int, scale: float):
    """q (B,H,R); pool (N, ps, R), the row the key and its first
    ``kv_lora`` dims the value; page_table (B,T) int32; pos (B,) int32;
    ``base`` as in :func:`paged_attend_gqa` → (o (B,H,kv_lora), m (B,H),
    l (B,H)) f32 partials."""
    global mla_launches
    if q.device.type == "cpu":
        return ref.paged_flash_decode_mla_ref(
            q, pool, page_table, pos, base, page_size=page_size,
            kv_lora=kv_lora, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged decode runs on cuda or cpu, not {q.device}")
    _check_mla(q, pool, page_table, pos, kv_lora)
    B, H, R = q.shape
    N, ps = pool.shape[:2]
    width = page_table.shape[1]
    # the table width bounds every slot's live keys (pos stays on the card)
    max_keys = width * ps
    splits = min(_MLA_MAX_SPLITS, -(-max_keys // _MLA_CHUNK))
    chunk = -(-max_keys // splits)
    f32 = dict(dtype=torch.float32, device=q.device)
    o = torch.empty((B, H, kv_lora), **f32)
    m = torch.empty((B, H), **f32)
    l = torch.empty_like(m)
    parts = (torch.empty((splits, B, H, kv_lora), **f32),
             torch.empty((splits, B, H), **f32),
             torch.empty((splits, B, H), **f32)) if splits > 1 else (o, m, l)
    lib = _lib()
    err = lib.paged_attention_mla(
        q.device.index or 0, _DTYPES[q.dtype], _build.ptr(q), _build.ptr(pool),
        _build.ptr(page_table), _build.ptr(pos), _build.ptr(o), _build.ptr(m),
        _build.ptr(l), *map(_build.ptr, parts), B, H, R, int(kv_lora), N, ps,
        width, int(page_size), int(base), float(scale), splits, chunk,
        _build.stream(q.device))
    _build.check(lib, err, "paged_attention_mla")
    mla_launches += 1
    return o, m, l
