"""The pure functions that choose the Hopper kernels' paths and size their
shared memory, against the constants the CUDA sources compile with. These
run without a card: the sources are read as text."""
import re
from pathlib import Path

import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.grouped_gemm import ops as gg_ops

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
    models' dims (64, 128 and MLA's (192, 128)) with aligned rows, mma.sync
    at dh = dv in {16, 32}, the CUDA cores for everything else."""
    for dh in range(1, flash_ops._MAX_DQK + 1):
        for dv in range(1, flash_ops._MAX_DV + 1):
            got = flash_ops.fwd_route(dtype, dh, dv, aligned)
            if dtype != torch.bfloat16 or not aligned:
                want = "f32"
            elif (dh, dv) in ((64, 64), (128, 128), (192, 128)):
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


# ------------------------------------------------- flash forward smem law
@pytest.mark.parametrize("dh,dv", [(64, 64), (128, 128), (192, 128)])
def test_fwd_smem_law(dh, dv):
    """The law fits a block, picks 3 stages where they fit and 2 where they
    do not, and equals the size flash_attention.cu asserts at compile
    time."""
    n = flash_ops.fwd_smem_bytes(dh, dv)
    assert n <= LIMIT == flash_ops.SMEM_LIMIT
    stages = flash_ops.fwd_stages(dh, dv)
    assert stages in (2, 3)
    assert (stages == 3) == (flash_ops._smem(dh, dv, 3) <= LIMIT)
    assert n == 1024 + 2 * 128 * dh + stages * 2 * 128 * (dh + dv) + \
        8 * (3 + 2 * stages)
    assert _asserted("flash_attention.cu", r"FwdSmem<\d+, \d+>::bytes")[
        f"FwdSmem<{dh}, {dv}>::bytes"] == n


def test_fwd_tiles_match_source():
    """The tiles of the law are the source's, and the source sizes (and
    compiles) the wgmma kernel at exactly the dims the route sends it."""
    assert _constexpr("flash_attention.cu", "WQ") == flash_ops.WQ
    assert _constexpr("flash_attention.cu", "WK") == flash_ops.WK
    sized = {tuple(map(int, re.findall(r"\d+", k))) for k in _asserted(
        "flash_attention.cu", r"FwdSmem<\d+, \d+>::bytes")}
    assert sized == set(flash_ops._WGMMA_DIMS)


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
])
def test_kernel_label(signature, label):
    """One short name for the SASS, ptxas and profiler lines: the name and
    template arguments, without return type, namespace or parameters."""
    assert _build.kernel_label(signature) == label
