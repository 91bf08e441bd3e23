"""Public paged-attention decode ops: GQA and absorbed MLA.

On CUDA tensors they launch the hand-written kernels
(``kernels/csrc/paged_attention.cu``) or raise; the plain versions in
``ref.py`` run only for tensors on the CPU. Outputs are the unnormalized
``(o, m, l)`` softmax partials that the caller combines. ``launches``
counts GQA calls that launched their kernel, ``mla_launches`` MLA calls.
A CUDA graph's replay runs no Python: ``serve/graphs.py`` records each
count's change while a graph is captured (and takes it back: a capture
launches nothing) and adds it at every replay, so the counts go on
counting kernel launches on the card.

Each op has two routes, chosen by a pure function of the call's shape and
dtype: the tensor-core kernels (:func:`gqa_route` "mma", :func:`mla_route`
"wgmma") for bf16 at the served models' shapes, one launch per call, and
the CUDA-core kernels ("f32") for everything else. :func:`split_plan` cuts
a slot's keys over blocks from the page table's width alone, so the grid
of a width bucket never depends on ``pos`` (which stays on the card).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build, _launches
from repro_torch.kernels.paged_attention import ref

launches = 0
mla_launches = 0

SMEM_LIMIT = 232448      # shared memory one block may opt into on an H100
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_GROUP = 8
_MAX_DIM = 256           # GQA head dims either route takes
_CORE_MAX_DIM = 256      # GQA head dims the CUDA-core kernel takes
CORE_WARPS = 8           # paged_gqa_kernel: warps per block
CORE_CAPS = (128, _CORE_MAX_DIM)   # its instances' head-dim caps
STATIC_SMEM = 48 * 1024  # shared memory a launch takes without opting in
_MLA_MAX_R = 1024
_MLA_MAX_LORA = 512

# Splits (csrc/paged_attention.cu): each tensor-core kernel's plan is
# (keys a block takes, most blocks a slot spreads over): chunks of at most
# that many keys unless a slot would take more blocks, longer chunks then;
# chunks are whole SPLIT_UNITs (one tile of every GQA warp; one MLA key
# tile). Measured on an H100 against fixed chunks of 256, 512 and 1024
# keys (examples/paged_chunk_sweep.py, PERF.md §6): GQA streams best in
# chunks of 512 (shorter ones drain each warp's ring sooner), MLA best in
# 8 splits a slot (8 slots x 2 head groups x 8 fill the SMs once at one
# 222 KB block each; more splits run a second wave and move more 128 KB
# partials)
GQA_PLAN = (512, 64)
MLA_PLAN = (256, 8)
SPLIT_UNIT = 64
# paged_gqa_mma: warps per block, keys per warp tile, tiles in each warp's
# ring; the head dims it is compiled for; the group padded to mma's n
GQ_WARPS, GQ_TILE, GQ_STAGES = 4, 16, 3
GQA_DIMS = (64, 128, 256)
GQ_N = 8
# paged_mla_wgmma: heads per block, keys per tile, stages of the key ring,
# the value dims (two warpgroups of 256), the row dims it is compiled for,
# and the pool page sizes its TMA boxes take (whole pages to a tile, each
# box 1024-byte aligned in the 128-byte swizzle)
ML_M, ML_KT, ML_STAGES = 64, 64, 2
ML_LORA = 512
MLA_R = (512, 576)
MLA_PS = (8, 16, 32, 64)
# its thread-block clusters: blocks of consecutive splits whose partials
# merge through distributed shared memory
ML_CLUSTER = 4

_ROUTES = {"f32": 0, "mma": 1, "wgmma": 1}
_I, _F, _P = ctypes.c_int, ctypes.c_float, ctypes.c_void_p
_ARGTYPES = [_I, _I] + [_P] * 12 + [_I] * 9 + [_F, _F] + [_I] * 3 + [_P]
_MLA_ARGTYPES = [_I, _I] + [_P] * 11 + [_I] * 9 + [_F] + [_I] * 3 + [_P]
# Arrival counters of the tensor-core kernels' in-launch merge, of each
# (kernel, device, stream): GQA one per (slot, kv head), MLA one per
# (slot, head group) and column slice (ML_CLUSTER). They are zero between
# calls (the last block of a row wraps its counter back to 0), so they are
# made once and grown; kernels on one stream run in order, so that
# stream's calls share them. A CUDA graph keeps the counter's pointer of
# its capture: an engine's capturing stream sees one row count (decode
# calls with B rows, a speculative engine's verify with B·K), made by the
# warm-up that precedes the capture, and a counter that grows keeps the
# one it replaces alive (``_retired``), so no graph points at freed memory
_counters: dict[tuple[str, int, int], torch.Tensor] = {}
_retired: list[torch.Tensor] = []


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def gqa_smem_bytes(dh: int) -> int:
    """Shared memory of one paged_gqa_mma block: each of GQ_WARPS warps'
    ring of GQ_STAGES K and V tiles of GQ_TILE rows of dh bf16 (GqaSmem in
    csrc/paged_attention.cu; the warps' partials reuse it)."""
    return GQ_WARPS * GQ_STAGES * 2 * GQ_TILE * dh * 2


def mla_smem_bytes(R: int) -> int:
    """Shared memory of one paged_mla_wgmma block: Q (ML_M x R) and
    ML_STAGES key tiles (ML_KT x R) in bf16, full and empty mbarriers per
    stage, and 1024 bytes to align the tiles to the 128-byte swizzle's
    period (MlaSmem in csrc/paged_attention.cu)."""
    return 1024 + (ML_M + ML_STAGES * ML_KT) * R * 2 + 8 * 2 * ML_STAGES


def gqa_core_cap(dh: int) -> int:
    """The head-dim cap of the paged_gqa_kernel instance that takes ``dh``:
    the smallest of CORE_CAPS that holds it."""
    return next(c for c in CORE_CAPS if dh <= c)


def gqa_core_smem_bytes(grp: int, cap: int) -> int:
    """Dynamic shared memory of one paged_gqa_kernel block at group ``grp``
    and head-dim cap ``cap``: the group's scaled query rows and the
    CORE_WARPS warps' partials (o rows, m, l) in f32
    (gqa_core_smem_bytes in csrc/paged_attention.cu). Past STATIC_SMEM
    the launch opts in to more."""
    return 4 * grp * (cap * (1 + CORE_WARPS) + 2 * CORE_WARPS)


def gqa_route(dtype: torch.dtype, grp: int, dh: int) -> str:
    """The GQA decode kernel for a call: "mma" (paged_gqa_mma: bf16, a
    group of at most 8 query rows, dh 64, 128 or 256) or "f32"
    (paged_gqa_kernel on the CUDA cores: f32, or any other group or head
    dim up to 256)."""
    if dtype == torch.bfloat16 and 1 <= grp <= GQ_N and dh in GQA_DIMS:
        return "mma"
    return "f32"


def mla_route(dtype: torch.dtype, H: int, R: int, kv_lora: int,
              ps: int) -> str:
    """The MLA decode kernel for a call: "wgmma" (paged_mla_wgmma: bf16,
    kv_lora 512, R 512 or 576, any head count H >= 1, pool pages of
    MLA_PS rows: one TMA box per page, whole pages to a 64-key tile) or
    "f32" (paged_mla_kernel on the CUDA cores: f32, or any other shape)."""
    if dtype == torch.bfloat16 and H >= 1 and kv_lora == ML_LORA and \
            R in MLA_R and ps in MLA_PS:
        return "wgmma"
    return "f32"


def split_plan(width: int, ps: int, plan: tuple[int, int]
               ) -> tuple[int, int]:
    """``(splits, chunk)``: the blocks a slot's keys spread over and the
    keys each takes, from the table width alone (its ``width * ps`` keys
    bound every slot's live keys) and a kernel's ``plan`` (GQA_PLAN,
    MLA_PLAN: keys a block takes, most blocks a slot spreads over): the
    fewest chunks of at most that many keys, at most ``most`` of them,
    evened out, each a whole number of SPLIT_UNIT keys, and no split that
    a full table leaves empty."""
    chunk, most = plan
    keys = width * ps
    splits = max(1, min(most, _cdiv(keys, chunk)))
    chunk = _cdiv(_cdiv(keys, splits), SPLIT_UNIT) * SPLIT_UNIT
    return _cdiv(keys, chunk), chunk


def _counter(kind: str, device, rows: int) -> torch.Tensor:
    dev = device.index or 0
    key = (kind, dev, _build.stream(device))
    cnt = _counters.get(key)
    if cnt is None or cnt.numel() < rows:
        if cnt is not None:
            _retired.append(cnt)
        cnt = torch.zeros(rows, dtype=torch.int32, device=device)
        _counters[key] = cnt
    return cnt


@functools.cache
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
    if q.device.type == "cpu":
        return ref.paged_flash_decode_gqa_ref(
            q, pool_k, pool_v, page_table, pos, base, page_size=page_size,
            scale=scale, softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"paged decode runs on cuda or cpu, not {q.device}")
    _check(q, pool_k, pool_v, page_table, pos)
    B, hkv, grp, dh = q.shape
    N, ps = pool_k.shape[:2]
    width = page_table.shape[1]
    route = gqa_route(q.dtype, grp, dh)
    splits, chunk = split_plan(width, ps, GQA_PLAN)
    f32 = dict(dtype=torch.float32, device=q.device)
    o = torch.empty((B, hkv * grp, dh), **f32)
    m = torch.empty((B, hkv * grp), **f32)
    l = torch.empty_like(m)
    ws = (None, None, None, None)
    if route == "mma" and splits > 1:
        ws = (torch.empty((splits, B, hkv, grp, dh), **f32),
              torch.empty((splits, B, hkv, grp), **f32),
              torch.empty((splits, B, hkv, grp), **f32),
              _counter("gqa", q.device, B * hkv))
    lib = _lib()
    err = lib.paged_attention_gqa(
        q.device.index or 0, _DTYPES[q.dtype], q.data_ptr(),
        pool_k.data_ptr(), pool_v.data_ptr(), page_table.data_ptr(),
        pos.data_ptr(), o.data_ptr(), m.data_ptr(), l.data_ptr(),
        *(None if t is None else t.data_ptr() for t in ws), B, hkv, grp, dh,
        N, ps, width, int(page_size), int(base), float(scale),
        float(softcap), splits, chunk, _ROUTES[route],
        _build.stream(q.device))
    _build.check(lib, err, "paged_attention_gqa")
    _launches.bump(__name__, "launches")
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
    route = mla_route(q.dtype, H, R, kv_lora, ps)
    if route == "wgmma" and q.data_ptr() % 16:
        raise ValueError("q must be 16-byte aligned")
    splits, chunk = split_plan(width, ps, MLA_PLAN)
    f32 = dict(dtype=torch.float32, device=q.device)
    o = torch.empty((B, H, kv_lora), **f32)
    m = torch.empty((B, H), **f32)
    l = torch.empty_like(m)
    ws = (None, None, None, None)
    if splits > 1:
        # the wgmma kernel's partials: one per cluster of ML_CLUSTER splits
        parts, cnt = splits, None
        if route == "wgmma":
            parts = _cdiv(splits, ML_CLUSTER)
            cnt = _counter("mla", q.device, B * _cdiv(H, ML_M) * ML_CLUSTER)
        ws = (torch.empty((parts, B, H, kv_lora), **f32),
              torch.empty((parts, B, H), **f32),
              torch.empty((parts, B, H), **f32), cnt)
    lib = _lib()
    err = lib.paged_attention_mla(
        q.device.index or 0, _DTYPES[q.dtype], q.data_ptr(), pool.data_ptr(),
        page_table.data_ptr(), pos.data_ptr(), o.data_ptr(), m.data_ptr(),
        l.data_ptr(), *(None if t is None else t.data_ptr() for t in ws), B,
        H, R, int(kv_lora), N, ps, width, int(page_size), int(base),
        float(scale), splits, chunk, _ROUTES[route], _build.stream(q.device))
    _build.check(lib, err, "paged_attention_mla")
    _launches.bump(__name__, "mla_launches")
    return o, m, l
