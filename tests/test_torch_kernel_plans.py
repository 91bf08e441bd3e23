"""The pure functions that choose the Hopper kernels' paths and size their
shared memory, against the constants the CUDA sources compile with. These
run without a card: the sources are read as text."""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.grouped_gemm import ops as gg_ops
from repro_torch.kernels.paged_attention import ops as paged_ops
from repro_torch.kernels.selective_scan import ops as scan_ops
from repro_torch.kernels.selective_scan import ref as scan_ref
from repro_torch.kernels.ssd import ops as ssd_ops

CSRC = Path(flash_ops.__file__).resolve().parents[1] / "csrc"
LIMIT = 227 * 1024            # shared memory one block may use on an H100


def _asserted(source: str, pattern: str) -> dict[str, int]:
    """{label: bytes} of every ``static_assert(<label> == <bytes>`` in a
    source whose label matches ``pattern``."""
    text = (CSRC / source).read_text()
    found = re.findall(rf"static_assert\(({pattern})\s*==\s*(\d+)", text)
    return {re.sub(r"\s+", " ", k): int(v) for k, v in found}


def _constexpr(source: str, name: str) -> int:
    m = re.search(rf"\b{name} = (\d+)", (CSRC / source).read_text())
    assert m, f"{name} not found in {source}"
    return int(m.group(1))


# ------------------------------------------------------ flash forward route
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("aligned", [True, False])
def test_fwd_route_every_dim(dtype, aligned):
    """Every (dh, dv) the wrapper accepts: the wgmma path for bf16 at the
    models' dims (64, 80, 128, 256 and MLA's (192, 128)) with aligned rows,
    mma.sync at dh = dv in {16, 32}, the CUDA cores for everything else."""
    assert flash_ops._MAX_DV == 256 == _constexpr("flash_attention.cu",
                                                  "MAXDV")
    for dh in range(1, flash_ops._MAX_DQK + 1):
        for dv in range(1, flash_ops._MAX_DV + 1):
            got = flash_ops.fwd_route(dtype, dh, dv, aligned)
            if dtype != torch.bfloat16 or not aligned:
                want = "f32"
            elif (dh, dv) in ((64, 64), (80, 80), (128, 128), (192, 128),
                              (256, 256)):
                want = "wgmma"
            elif dh == dv and dh in (16, 32):
                want = "mma"
            else:
                want = "f32"
            assert got == want, (dtype, dh, dv, aligned, got)


def test_fwd_route_alignment_from_views():
    """Head-transposed views and MLA's v slice (256 bytes into each row)
    count as aligned; an odd stride does not."""
    B, T, H, dh = 2, 8, 4, 128
    q = torch.zeros((B, T, H, dh), dtype=torch.bfloat16).permute(0, 2, 1, 3)
    kv = torch.zeros((B, T, H, 256), dtype=torch.bfloat16)
    v = kv[..., 128:].permute(0, 2, 1, 3)
    assert flash_ops._aligned(q, q, v)
    odd = torch.zeros((B, H, T, dh + 1), dtype=torch.bfloat16)[..., :dh]
    assert not flash_ops._aligned(q, odd, v)


# ----------------------------------------------------- flash backward route
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("aligned", [True, False])
def test_bwd_route_every_dim(dtype, aligned):
    """Every (dh, dv) the backward accepts: the mma.sync passes for bf16 at
    (64, 64), (128, 128) and (192, 128) with aligned rows (whisper's 64,
    the GQA models' 128, MLA's nope + rope and v), the CUDA cores for
    everything else; flash_attention_bwd.cu's own condition names the same
    dims, and refuses route 1 where it does not hold."""
    text = (CSRC / "flash_attention_bwd.cu").read_text()
    assert "((dh == dv_dim && (dh == 64 || dh == 128)) ||" in text
    assert "(dh == 192 && dv_dim == 128))" in text
    assert "if (route == 1 && !tc) return (int)cudaErrorInvalidValue;" in text
    assert flash_ops._ROUTES["mma"] == 1 and flash_ops._ROUTES["f32"] == 0
    for dh in range(1, flash_ops._MAX_BWD + 1):
        for dv in range(1, flash_ops._MAX_BWD + 1):
            got = flash_ops.bwd_route(dtype, dh, dv, aligned)
            want = "mma" if dtype == torch.bfloat16 and aligned and \
                (dh, dv) in ((64, 64), (128, 128), (192, 128)) else "f32"
            assert got == want, (dtype, dh, dv, aligned, got)


# ------------------------------------------------- flash forward smem law
@pytest.mark.parametrize("dh,dv", [(64, 64), (128, 128), (192, 128),
                                   (80, 80)])
def test_fwd_smem_law(dh, dv):
    """The law fits a block, picks 3 stages where they fit and 2 where they
    do not, and equals the size flash_attention.cu asserts at compile time
    for the instance that computes (dh, dv): dh = dv = 80 is the (128,
    128) instance's."""
    DH, DV = flash_ops.wgmma_instance(dh, dv)
    assert (DH, DV) == ((128, 128) if dh == 80 else (dh, dv))
    n = flash_ops.fwd_smem_bytes(dh, dv)
    assert n <= LIMIT == flash_ops.SMEM_LIMIT
    stages = flash_ops.fwd_stages(dh, dv)
    assert stages in (2, 3)
    assert (stages == 3) == (flash_ops._smem(DH, DV, 3) <= LIMIT)
    assert n == 1024 + 2 * 128 * DH + stages * 2 * 128 * (DH + DV) + \
        8 * (3 + 2 * stages)
    assert _asserted("flash_attention.cu", r"FwdSmem<\d+, \d+>::bytes")[
        f"FwdSmem<{DH}, {DV}>::bytes"] == n


def test_fwd_smem_law_dh256():
    """At dh = dv = 256 (gemma2-2b) the key tiles are 64 rows (the output
    accumulator takes 128 registers a thread), two stages fit and three do
    not, and the law equals the size flash_attention.cu asserts."""
    assert flash_ops.fwd_kn(256) == 64 and flash_ops.fwd_kn(128) == 128
    assert flash_ops.fwd_stages(256, 256) == 2
    n = flash_ops.fwd_smem_bytes(256, 256)
    assert n == 1024 + 2 * 128 * 256 + 2 * 2 * 64 * 512 + 8 * 7 <= LIMIT
    assert 1024 + 2 * 128 * 256 + 3 * 2 * 64 * 512 + 8 * 9 > LIMIT
    assert _asserted("flash_attention.cu", r"FwdSmem<\d+, \d+>::bytes")[
        "FwdSmem<256, 256>::bytes"] == n


def test_fwd_tiles_match_source():
    """The tiles of the law are the source's, and the source sizes (and
    compiles) the wgmma kernel at exactly the instances the route's dims
    take: each its own, and dh = dv = 80 the (128, 128) instance, whose
    second 64-column box reaches past 80 (TMA zero-fills columns 80-127)
    and whose launch the source dispatches for dh <= 128."""
    assert _constexpr("flash_attention.cu", "WQ") == flash_ops.WQ
    assert _constexpr("flash_attention.cu", "WK") == flash_ops.WK
    sized = {tuple(map(int, re.findall(r"\d+", k))) for k in _asserted(
        "flash_attention.cu", r"FwdSmem<\d+, \d+>::bytes")}
    assert sized == {flash_ops.wgmma_instance(*d)
                     for d in flash_ops._WGMMA_DIMS}
    for (dh, dv), (DH, DV) in flash_ops._WGMMA_PADDED.items():
        assert (dh, dv) in flash_ops._WGMMA_DIMS and (DH, DV) in sized
        assert DH - 64 < dh < DH and DV - 64 < dv < DV and dv % 8 == 0
    text = (CSRC / "flash_attention.cu").read_text()
    assert "(dh == 64 || dh == 80 || dh == 128 || dh == 256)" in text
    assert ": dh <= 128 ? launch_wgmma<128, 128>" in text


# --------------------------------------------------- grouped GEMM route
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gg_route_every_m(dtype):
    """M up to 16 (decode's token rows) takes the decode path, anything
    taller the prefill path; f32 the CUDA cores."""
    for M in range(1, 2049):
        got = gg_ops.route(dtype, M)
        if dtype != torch.bfloat16:
            assert got == "f32"
        else:
            assert got == ("decode" if M <= 16 else "prefill"), (M, got)


@pytest.mark.parametrize("path", ["prefill", "decode"])
def test_gg_smem_law(path):
    """Each bf16 path's law fits a block and equals the size
    grouped_gemm.cu asserts at compile time; decode's ring is small enough
    for three blocks per SM (228 KiB, 1 KiB reserved each)."""
    n = gg_ops.smem_bytes(path)
    assert n <= LIMIT == gg_ops.SMEM_LIMIT
    bm, bn, bk, stages = gg_ops.TILES[path]
    assert n == 1024 + stages * (2 * bk * (bm + bn) + 16)
    label = {"prefill": "PrefillSmem::bytes", "decode": "DecodeSmem::bytes"}
    assert _asserted("grouped_gemm.cu", r"\w+Smem::bytes")[label[path]] == n
    if path == "decode":
        assert 3 * (n + 1024) <= 228 * 1024


def test_gg_tiles_match_source():
    src = "grouped_gemm.cu"
    assert gg_ops.TILES["prefill"] == (
        _constexpr(src, "PM"), _constexpr(src, "PN"), _constexpr(src, "GK"),
        _constexpr(src, "PSTAGES"))
    assert gg_ops.TILES["decode"] == (
        _constexpr(src, "DM"), _constexpr(src, "DN"), _constexpr(src, "GK"),
        _constexpr(src, "DSTAGES"))
    assert gg_ops.DECODE_M == _constexpr(src, "DM")


# ---------------------------------------------------------- kernel labels
@pytest.mark.parametrize("signature,label", [
    # the profiler's names, then cu++filt's
    ("void (anonymous namespace)::flash_fwd_wgmma<128, 128>(CUtensorMap_st, "
     "CUtensorMap_st, CUtensorMap_st, __nv_bfloat16*, float*, "
     "(anonymous namespace)::Strides, int, int, int, int, int, float, int, "
     "int, float, int, int*)", "flash_fwd_wgmma<128, 128>"),
    ("void <unnamed>::flash_fwd_wgmma<(int)192, (int)128>(CUtensorMap_st, "
     "CUtensorMap_st, CUtensorMap_st, __nv_bfloat16 *, float *, "
     "<unnamed>::Strides, int, int, int, int, int, float, int, int, float, "
     "int, int *)", "flash_fwd_wgmma<192, 128>"),
    ("<unnamed>::gg_decode(CUtensorMap_st, CUtensorMap_st, __nv_bfloat16 *, "
     "int, int, int, int, int)", "gg_decode"),
    ("void (anonymous namespace)::bwd_dkv_mma<128>(__nv_bfloat16 const*, "
     "(anonymous namespace)::Strides, int, int, int, "
     "(anonymous namespace)::Mask, float, float)", "bwd_dkv_mma<128>"),
    # a kernel that is not a template has no return type in its name
    ("(anonymous namespace)::gg_prefill(CUtensorMap_st, CUtensorMap_st, "
     "__nv_bfloat16*, int, int, int, int, long, long, int*)", "gg_prefill"),
    ("void (anonymous namespace)::flash_fwd_kernel<__nv_bfloat16>("
     "__nv_bfloat16 const*, __nv_bfloat16 const*)",
     "flash_fwd_kernel<__nv_bfloat16>"),
    ("void at::native::vectorized_elementwise_kernel<4, "
     "at::native::AbsFunctor<float>, std::array<char*, 2ul> >(int, "
     "at::native::AbsFunctor<float>, std::array<char*, 2ul>)",
     "vectorized_elementwise_kernel<4, at::native::AbsFunctor<float>, "
     "std::array<char*, 2ul> >"),
    ("gemm_f32", "gemm_f32"),
    # a bool template argument: the profiler's false, cu++filt's (bool)0
    ("void (anonymous namespace)::paged_gqa_mma<128, false>(__nv_bfloat16 "
     "const*, __nv_bfloat16 const*)", "paged_gqa_mma<128, 0>"),
    ("void <unnamed>::paged_gqa_mma<(int)64, (bool)1>(__nv_bfloat16 const *)",
     "paged_gqa_mma<64, 1>"),
])
def test_kernel_label(signature, label):
    """One short name for the SASS, ptxas and profiler lines: the name and
    template arguments, without return type, namespace or parameters."""
    assert _build.kernel_label(signature) == label


# ------------------------------------------------- paged decode routes
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gqa_route_every_shape(dtype):
    """Every (group, dh) the GQA wrapper accepts: the tensor-core kernel for
    bf16 at dh 64, 128 and 256 (the source's instances), the CUDA cores for
    the rest (f32 included up to dh 256); the served models' (G 4, dh 128)
    and gemma2-2b's (G 2, dh 256) among the first."""
    assert paged_ops._CORE_MAX_DIM == _constexpr("paged_attention.cu",
                                                 "MAXD")
    for grp in range(1, paged_ops._MAX_GROUP + 1):
        for dh in range(8, paged_ops._MAX_DIM + 1, 8):
            want = "mma" if dtype == torch.bfloat16 and \
                dh in (64, 128, 256) else "f32"
            assert paged_ops.gqa_route(dtype, grp, dh) == want, (grp, dh)
    assert paged_ops.gqa_route(torch.bfloat16, 4, 128) == "mma"
    assert paged_ops.gqa_route(torch.bfloat16, 2, 256) == "mma"
    sized = {int(k.split("<")[1].split(">")[0]) for k in _asserted(
        "paged_attention.cu", r"GqaSmem<\d+>::bytes")}
    assert sized == set(paged_ops.GQA_DIMS)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mla_route_every_shape(dtype):
    """Every (R, kv_lora) the MLA wrapper accepts, at head counts that fill
    and that leave part of a 64-head block and at several page sizes: the
    wgmma kernel for bf16 with kv_lora 512, R 512 or 576 (deepseek-v2: 512
    + rope 64; the only R of whole 64-column blocks whose tiles fit a
    block's shared memory) and pages of 8 to 64 rows (a TMA box per page,
    whole pages to a 64-key tile); the CUDA cores for the rest."""
    for H, ps in ((1, 16), (16, 8), (96, 64), (128, 16), (128, 4),
                  (128, 12), (128, 128)):
        for R in range(8, paged_ops._MLA_MAX_R + 1, 8):
            for lora in sorted({8, 64, 256, 512, min(R, 512)}):
                if lora > R:
                    continue
                want = "wgmma" if dtype == torch.bfloat16 and \
                    lora == 512 and R in (512, 576) and \
                    ps in (8, 16, 32, 64) else "f32"
                assert paged_ops.mla_route(dtype, H, R, lora, ps) == want, \
                    (H, ps, R, lora)
    fits = [R for R in range(512, paged_ops._MLA_MAX_R + 1, 64)
            if paged_ops.mla_smem_bytes(R) <= LIMIT]
    assert tuple(fits) == paged_ops.MLA_R
    sized = {int(k.split("<")[1].split(">")[0]) for k in _asserted(
        "paged_attention.cu", r"MlaSmem<\d+>::bytes")}
    assert sized == set(paged_ops.MLA_R)


@pytest.mark.parametrize("kernel", ["gqa", "mla"])
@pytest.mark.parametrize("ps", [1, 8, 16, 32])
def test_split_plan_every_width(kernel, ps):
    """Every table width up to 600 pages at each kernel's plan (keys a
    block takes, most blocks a slot): the chunks cover the table, are whole
    SPLIT_UNITs, as few as chunks of at most the plan's keys allow (longer
    ones past the plan's most), and a full table leaves no split empty.
    The main path's table (256 pages of 16) takes 8 splits of 512 keys in
    both kernels; serving's ~1k-context table (128 pages) 4 of 512 (GQA)
    and 8 of 256 (MLA)."""
    plan = paged_ops.GQA_PLAN if kernel == "gqa" else paged_ops.MLA_PLAN
    want, most = plan
    assert want % paged_ops.SPLIT_UNIT == 0
    for width in range(1, 601):
        keys = width * ps
        splits, chunk = paged_ops.split_plan(width, ps, plan)
        assert splits * chunk >= keys and (splits - 1) * chunk < keys
        assert chunk % paged_ops.SPLIT_UNIT == 0
        assert 1 <= splits <= most
        if -(-keys // want) <= most:                # fewest, evened out
            assert splits == -(-keys // want) and chunk <= want
        else:
            assert chunk >= want
    assert paged_ops.split_plan(256, 16, plan) == (8, 512)
    assert paged_ops.split_plan(128, 16, plan) == \
        ((4, 512) if kernel == "gqa" else (8, 256))


@pytest.mark.parametrize("dh", [64, 128])
def test_gqa_smem_law(dh):
    """The GQA law equals the size paged_attention.cu asserts, fits two
    blocks per SM (228 KiB, 1 KiB reserved each), and holds the warps'
    partials that reuse it."""
    n = paged_ops.gqa_smem_bytes(dh)
    assert n == 4 * 3 * 2 * 16 * dh * 2
    assert _asserted("paged_attention.cu", r"GqaSmem<\d+>::bytes")[
        f"GqaSmem<{dh}>::bytes"] == n
    assert 2 * (n + 1024) <= 228 * 1024
    assert paged_ops.GQ_WARPS * paged_ops.GQ_N * (dh + 2) * 4 <= n


def test_gqa_smem_law_dh256():
    """At dh 256 the rings take 192 KiB: one block per SM fits, and the
    warps' partials fit in the ring they reuse."""
    n = paged_ops.gqa_smem_bytes(256)
    sized = _asserted("paged_attention.cu", r"GqaSmem<\d+>::bytes")
    assert n == 196608 == sized["GqaSmem<256>::bytes"]
    assert n + 1024 <= 228 * 1024 < 2 * (n + 1024)
    assert paged_ops.GQ_WARPS * paged_ops.GQ_N * (256 + 2) * 4 <= n


@pytest.mark.parametrize("grp", range(1, 9))
def test_gqa_core_smem_law(grp):
    """The CUDA-core GQA kernel's dynamic shared memory (the group's query
    rows and 8 warps' partials in f32, sized by the instance's head-dim
    cap): every head dim up to 256 takes the smallest cap that holds it,
    the law equals every size paged_attention.cu asserts, fits one block,
    and passes the 48 KB a launch takes without opting in only at cap 256
    with a group above 5 (gemma2-2b's G 2 at dh 256: 18,560 bytes)."""
    assert paged_ops.CORE_CAPS[-1] == paged_ops._CORE_MAX_DIM == \
        paged_ops._MAX_DIM == _constexpr("paged_attention.cu", "MAXD")
    assert paged_ops.CORE_WARPS == _constexpr("paged_attention.cu", "WARPS")
    for dh in range(8, paged_ops._CORE_MAX_DIM + 1, 8):
        cap = paged_ops.gqa_core_cap(dh)
        assert cap == (128 if dh <= 128 else 256), dh
    for cap in paged_ops.CORE_CAPS:
        n = paged_ops.gqa_core_smem_bytes(grp, cap)
        assert n == 4 * grp * (9 * cap + 16) <= LIMIT
        assert (n > paged_ops.STATIC_SMEM) == (cap == 256 and grp > 5)
    sized = _asserted("paged_attention.cu",
                      r"gqa_core_smem_bytes\(\d+, \d+\)")
    assert len(sized) >= 4
    for label, n in sized.items():
        g, cap = map(int, re.findall(r"\d+", label))
        assert paged_ops.gqa_core_smem_bytes(g, cap) == n, label
    assert paged_ops.gqa_core_smem_bytes(2, 256) == 18560


@pytest.mark.parametrize("R", [512, 576])
def test_mla_smem_law(R):
    """The MLA law (Q and two key tiles of 64 rows, barriers, alignment)
    equals the size paged_attention.cu asserts and fits one block, and the
    staged partial of the merge fits over Q and the tiles."""
    n = paged_ops.mla_smem_bytes(R)
    assert n == 1024 + 3 * 64 * R * 2 + 32 <= LIMIT == paged_ops.SMEM_LIMIT
    # the merge stages the block's partial (64 x 520 f32, m, l) and the
    # cluster's m, l over Q and the ring
    assert 64 * (512 + 8) * 4 + 2 * 64 * 4 * (1 + paged_ops.ML_CLUSTER) \
        <= 3 * 64 * R * 2
    assert _asserted("paged_attention.cu", r"MlaSmem<\d+>::bytes")[
        f"MlaSmem<{R}>::bytes"] == n


def test_paged_tiles_match_source():
    src = "paged_attention.cu"
    assert (paged_ops.GQ_WARPS, paged_ops.GQ_TILE, paged_ops.GQ_STAGES,
            paged_ops.GQ_N) == tuple(_constexpr(src, n) for n in (
                "GQ_WARPS", "GQ_TILE", "GQ_STAGES", "GQ_N"))
    assert (paged_ops.ML_M, paged_ops.ML_KT, paged_ops.ML_STAGES,
            paged_ops.ML_LORA, paged_ops.ML_CLUSTER) == tuple(
                _constexpr(src, n) for n in ("ML_M", "ML_KT", "ML_STAGES",
                                             "ML_LORA", "ML_CLUSTER"))
    # a GQA split holds whole tiles of every warp, an MLA split whole tiles
    assert paged_ops.SPLIT_UNIT % (paged_ops.GQ_WARPS * paged_ops.GQ_TILE) \
        == 0 and paged_ops.SPLIT_UNIT % paged_ops.ML_KT == 0


# -------------------------------------------------- Mamba-1 selective scan
def test_scan_constants_match_source():
    """ops.py's scan constants are the ``constexpr``s selective_scan.cu
    compiles with: the state widths it takes, the tile (the checkpoint
    interval, ``ref.TILE``), the forward's lanes, channels and ring and the
    backward's lanes (of a pair of channels) and channels (one dB and dC
    partial a block); the forward's lanes a channel by state width."""
    src = "selective_scan.cu"
    assert (scan_ops.NMUL, scan_ops.N_MAX, scan_ops.TS, scan_ops.FTHREADS,
            scan_ops.FSTAGES, scan_ops.BLANES, scan_ops.BBUF) == tuple(
        _constexpr(src, n) for n in ("NMUL", "N_MAX", "TS", "FTHREADS",
                                     "FSTAGES", "BLANES", "BBUF"))
    assert scan_ops.TS == scan_ref.TILE
    lanes = _asserted(src, r"flanes\(\d+\)")
    assert len(lanes) == 2
    for label, n in lanes.items():
        assert scan_ops.flanes(int(label[7:-1])) == n, label
    for N in range(scan_ops.NMUL, scan_ops.N_MAX + 1, scan_ops.NMUL):
        assert N % scan_ops.flanes(N) == 0 and \
            scan_ops.fcpb(N) * scan_ops.flanes(N) == scan_ops.FTHREADS
    # the backward's lanes hold two channels each
    assert scan_ops.BCPB == 2 * _constexpr(src, "BTHREADS") // scan_ops.BLANES
    assert scan_ops.SMEM_LIMIT == LIMIT


def test_scan_smem_law():
    """Every instance (N = 8 .. 64) fits the shared memory a block may use,
    and ops.py's laws give the bytes selective_scan.cu asserts. At jamba's
    N 16 the backward keeps the whole 16-step interval's states and decays
    in registers (one exp a state entry and step); a lane never holds more
    than 136 of them."""
    for N in range(scan_ops.NMUL, scan_ops.N_MAX + 1, scan_ops.NMUL):
        assert 0 < scan_ops.fwd_smem_bytes(N) <= LIMIT, N
        assert 0 < scan_ops.bwd_smem_bytes(N) <= LIMIT, N
        entries = 2 * N // scan_ops.BLANES     # a lane: two channels
        sub = scan_ops.sub_steps(entries)
        assert scan_ops.TS % sub == 0 and (2 * sub + 1) * entries <= 136, N
    found = _asserted("selective_scan.cu", r"(?:fwd|bwd)_smem_bytes\(\d+\)")
    assert len(found) == 4
    for label, n in found.items():
        kind, N = re.match(r"(\w+)\((\d+)\)", label).groups()
        assert getattr(scan_ops, kind)(int(N)) == n, label
    assert scan_ops.sub_steps(2 * 16 // scan_ops.BLANES) == scan_ops.TS


# --------------------------------------------------------- SSD intra-chunk
def _mamba2_launch_shapes():
    """(chunk rows G, Q) of every exact-length prefill group of the mamba2
    serve run (chip_smoke.py::mamba_phase's 12 prompts, numpy seed 0; one
    prompt a group; chunk 256, a shorter prompt its own Q)."""
    lens = np.random.default_rng(0).integers(16, 2001, 12)
    return sorted({(-(-int(n) // 256), min(256, int(n))) for n in lens})


def test_ssd_route_every_shape():
    """The tensor cores for P <= 64 and N <= 128, multiples of 8, on aligned
    rows (mamba2's P 64, N 128 among them); the CUDA cores for the rest (P
    72, N 40 of the card tests among them)."""
    for P in range(1, 137):
        for N in range(1, 201):
            for aligned in (True, False):
                want = "mma" if aligned and P % 8 == 0 and P <= 64 and \
                    N % 8 == 0 and N <= 128 else "f32"
                assert ssd_ops.ssd_route(P, N, aligned) == want, (P, N)
    assert ssd_ops.ssd_route(64, 128, True) == "mma"
    assert ssd_ops.ssd_route(72, 40, True) == "f32"


def test_ssd_route_of_views():
    """ssd_scan's views (heads second, B and C stride 0 over heads) are
    aligned and shared; B and C of their own per head keep the route and
    take one head a block; a row stride that is not a multiple of 4 leaves
    the tensor cores."""
    G, Q, H, P, N = 2, 97, 24, 64, 128
    x = torch.zeros((G, Q, H, P)).permute(0, 2, 1, 3)
    Bm = torch.zeros((G, Q, N))[:, None].expand(-1, H, -1, -1)
    assert ssd_ops.route_of(x, Bm, Bm) == "mma"
    assert ssd_ops.plan_of(x, Bm, Bm) == ssd_ops.ssd_plan(G, H, Q, N, True)
    own = torch.zeros((G, H, Q, N))
    assert ssd_ops.route_of(x, own, own) == "mma"
    assert ssd_ops.plan_of(x, own, own)[:2] == (1, 1)
    odd = torch.zeros((G, H, Q, N + 2))[..., :N]
    assert ssd_ops.route_of(x, odd, odd) == "f32"


@pytest.mark.parametrize("G,Q", _mamba2_launch_shapes())
def test_ssd_plan_launch_shapes(G, Q):
    """Every launch shape of the mamba2 serve run: head groups that cover
    the 24 heads exactly, the grid's classes longest first, and the block
    count the kernel launches."""
    H, P, N = 24, 64, 128
    plan = ssd_ops.ssd_plan(G, H, Q, N, True)
    assert 1 <= plan.hpb <= ssd_ops.HPB_MAX and H % plan.hpb == 0
    assert 1 <= plan.hs <= ssd_ops.HS_MAX and H % plan.hs == 0
    nt = -(-Q // 64)
    assert plan.blocks == G * (nt * (H // plan.hpb) + H // plan.hs)
    ys, (s_steps, _) = ssd_ops._costs(G, H, Q, N, plan.hpb, plan.hs)
    order = [c for c, _ in ys[:plan.state_pos]] + [s_steps] + \
        [c for c, _ in ys[plan.state_pos:]]
    assert order == sorted(order, reverse=True)
    assert ssd_ops.ssd_plan(G, H, Q, N, False)[:2] == (1, 1)


def test_ssd_plan_main_shape():
    """mamba2's 8 chunk rows x 24 heads at Q 256 (a 1827- or 2000-token
    prompt): scores shared by 4 heads, the state 2 heads a block, 288
    blocks (at least one per SM), the state blocks after the y blocks of
    the last two t tiles."""
    plan = ssd_ops.ssd_plan(8, 24, 256, 128, True)
    assert plan == (4, 2, 2, 288)
    assert plan.blocks >= ssd_ops.SMS


def test_ssd_smem_law():
    """The shared memory ssd.cu asserts for one ssd_mma block fits what a
    block may use (one block an SM)."""
    n = _asserted("ssd.cu", r"MmaSmem::bytes")["MmaSmem::bytes"]
    assert 0 < n <= LIMIT


def test_ssd_tiles_match_source():
    assert (ssd_ops.MT, ssd_ops.MP, ssd_ops.MN, ssd_ops.SK, ssd_ops.HPB_MAX,
            ssd_ops.HS_MAX) == tuple(_constexpr("ssd.cu", n) for n in (
                "MT", "MP", "MN", "SK", "HPB_MAX", "HS_MAX"))


_TF32_MASK = torch.tensor(-8192, dtype=torch.int32)    # 0xffffe000


def _tf32(v):
    """v with the low 13 mantissa bits cleared (a TF32 value)."""
    return (v.view(torch.int32) & _TF32_MASK).view(torch.float32)


def _split_mm(eq, a, b, products):
    """ssd_mma's product on the CPU: with 3 products each operand is hi +
    lo, both TF32 (hi truncates v, lo the rest v - hi), and a b = a_lo b_hi
    + a_hi b_lo + a_hi b_hi in f32; with 1, a_hi b_hi alone (plain TF32)."""
    ah, bh = _tf32(a), _tf32(b)
    out = torch.einsum(eq, ah, bh)
    if products == 3:
        al, bl = _tf32(a - ah), _tf32(b - bh)
        out = torch.einsum(eq, al, bh) + torch.einsum(eq, ah, bl) + out
    return out


def _ssd64(x, cs, B, C):
    """The plain version's arithmetic (ref.py) in f64, B and C (G, Q, N)
    shared by the heads."""
    x, cs, B, C = (t.double() for t in (x, cs, B, C))
    Q = x.shape[2]
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool))
    L = torch.where(tri, torch.exp(cs[..., :, None] - cs[..., None, :]), 0.0)
    y = torch.einsum("gts,ghts,ghsp->ghtp", torch.einsum("gtn,gsn->gts", C, B),
                     L, x)
    d = torch.exp(cs[..., -1:] - cs)[..., None]
    return y, torch.einsum("gsn,ghsp->ghnp", B, x * d)


@pytest.mark.parametrize("products", [3, 1])
def test_ssd_split_error(products):
    """The arithmetic of ssd_mma emulated at mamba2's shape (8 chunk rows x
    24 heads, Q 256, P 64, N 128; seed 0): scores once per chunk row, the
    mask by selection, every operand split after masking and scaling. With
    3xTF32 y and st stay within 1e-5 (relative max error) of the plain
    version, ten times inside the card tests' 1e-4; one TF32 product would
    miss the f32 contract. The decays are f64 exps rounded once to f32 (the
    card's exp2f is within 2 ulp; torch.exp in f32 on some CPUs is not: it
    has put 1e-4 into L), and the yardstick is the plain version's
    arithmetic in f64."""
    G, H, Q, P, N = 8, 24, 256, 64, 128
    rng = np.random.default_rng(0)
    f32 = np.float32
    x = torch.from_numpy(rng.standard_normal((G, Q, H, P)).astype(f32))
    a = torch.from_numpy(rng.standard_normal((G, Q, H)).astype(f32))
    cs = torch.cumsum(-torch.nn.functional.softplus(a), dim=1)
    Bm = torch.from_numpy(rng.standard_normal((G, Q, N)).astype(f32))
    Cm = torch.from_numpy(rng.standard_normal((G, Q, N)).astype(f32))
    xv, csv = x.permute(0, 2, 1, 3), cs.permute(0, 2, 1)
    yr, str_ = _ssd64(xv, csv, Bm, Cm)

    def exp(v):
        return torch.exp(v.double()).float()

    S = _split_mm("gtn,gsn->gts", Cm, Bm, products)[:, None]
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool))
    L = exp(csv[..., :, None] - csv[..., None, :])
    y = _split_mm("ghts,ghsp->ghtp", torch.where(tri, S * L, 0.0), xv,
                  products)
    d = exp(csv[..., -1:] - csv)[..., None]
    st = _split_mm("gsn,ghsp->ghnp", Bm, xv * d, products)

    err = max(float((y - yr).abs().max() / yr.abs().max()),
              float((st - str_).abs().max() / str_.abs().max()))
    if products == 3:
        assert err < 1e-5, err
    else:
        assert err > 1e-4, err
