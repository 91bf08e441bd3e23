"""The paper's core in the port against the JAX package on the CPU: the
tiled GEMM's plain version against the Pallas kernel in interpret mode,
the shared-memory capacity law, the HBB row split, the chunk laws, the
``parallel_for`` schedulers, the throughput tracker, the straggler
monitor, the energy model, the batch partitioner and the heterogeneous
GEMM driver. Inputs come from numpy seeds."""
import os
import sys
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.core import chunking as jchunk
from repro.core import energy as jenergy
from repro.core import hbb as jhbb
from repro.core.straggler import StragglerMonitor as JStragglerMonitor
from repro.core.tracker import ThroughputTracker as JThroughputTracker
from repro.kernels.gemm import ops as jgemm_ops
from repro.kernels.gemm.gemm import gemm as jgemm
from repro.kernels.gemm.gemm import vmem_bytes
from repro_torch.configs import gemm_paper
from repro_torch.core import chunking, energy
from repro_torch.core.hbb import Body, ChunkRecord, Dynamic, Params, RunReport
from repro_torch.core.partitioner import HeterogeneousBatchPartitioner, Tier
from repro_torch.core.straggler import StragglerMonitor
from repro_torch.core.tracker import ThroughputTracker
from repro_torch.examples import hetero_gemm
from repro_torch.kernels.gemm import ops, ref

# f32 and bf16 tolerances of tests/test_kernels.py::test_gemm_sweep
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _operands(M, K, N, dtype, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(M, K)).astype(np.float32)
    b = rng.normal(size=(K, N)).astype(np.float32)
    return ((jnp.asarray(a).astype(JDT[dtype]), jnp.asarray(b).astype(
        JDT[dtype])), (torch.from_numpy(a).to(TDT[dtype]),
                       torch.from_numpy(b).to(TDT[dtype])))


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


# ------------------------------------------------------------------ GEMM
@pytest.mark.parametrize("M,N,K", [(128, 128, 128), (256, 512, 384),
                                   (64, 256, 1024)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gemm_plain_matches_pallas_interpret(M, N, K, dtype):
    """The shapes and JAX block shape of test_kernels.py::test_gemm_sweep;
    the port runs one of its compiled block shapes (the result does not
    depend on it)."""
    (ja, jb), (a, b) = _operands(M, K, N, dtype)
    want = jgemm(ja, jb, bm=64, bn=64, bk=128, interpret=True)
    out = ops.gemm(a, b, bm=64, bn=64, bk=32)
    assert out.dtype == a.dtype and out.shape == (M, N)
    _close(out, want, TOL[dtype])
    _close(ref.gemm_ref(a, b), want, TOL[dtype])


@pytest.mark.parametrize("jblock,block", [((32, 32, 64), (64, 32, 32)),
                                          ((128, 64, 128), (128, 128, 32))])
def test_gemm_block_shapes(jblock, block):
    (ja, jb), (a, b) = _operands(256, 256, 256, "float32", seed=1)
    bm, bn, bk = jblock
    want = jgemm(ja, jb, bm=bm, bn=bn, bk=bk, interpret=True)
    bm, bn, bk = block
    _close(ops.gemm(a, b, bm=bm, bn=bn, bk=bk), want, TOL["float32"])


def test_gemm_ragged_rows_match_jax_ref():
    """HBB hands the accelerator chunks of any row count; the plain version
    (and the kernel, which masks the ragged edge) take any M."""
    (ja, jb), (a, b) = _operands(97, 64, 96, "float32", seed=2)
    _close(ops.gemm(a[3:90], b), np.asarray(ja)[3:90] @ np.asarray(jb),
           TOL["float32"])


def test_gemm_smem_law():
    """The capacity law against the 227 KiB one block may opt into: every
    compiled shape fits in both dtypes, the JAX defaults (256, 256, 512)
    fit the TPU's 16 MiB VMEM but not the card, and a shape over the law
    raises instead of being clamped."""
    limit = 227 * 1024
    assert ops.SMEM_LIMIT == limit
    for bm, bn, bk in ops.SHAPES:
        for itemsize in (2, 4):
            assert ops.smem_bytes(bm, bn, bk, itemsize) <= limit
    assert {bn for _, bn, _ in ops.SHAPES} >= {32, 64, 128, 256}
    assert vmem_bytes(256, 256, 512) < 16 * 2**20
    assert ops.smem_bytes(256, 256, 512, 2) > limit
    assert ops.smem_bytes(256, 256, 512, 4) > limit
    # the law counts what the kernel allocates: padded tiles, no accumulator;
    # f32 tiles row-major in a ring of three stages
    assert ops.smem_bytes(128, 128, 32, 2) == (128 * 40 + 32 * 136) * 2
    assert ops.smem_bytes(128, 128, 32, 4) == 3 * (128 * 36 + 32 * 132) * 4
    _, (a, b) = _operands(64, 64, 64, "float32")
    with pytest.raises(ValueError, match="shared memory"):
        ops.gemm(a, b, bm=256, bn=256, bk=512)
    with pytest.raises(ValueError, match="not compiled"):
        ops.gemm(a, b, bm=32, bn=32, bk=32)
    assert (ops.BM, ops.BN, ops.BK) in ops.SHAPES


@pytest.mark.parametrize("M,N,K", [(sf, 1024, 1024)
                                   for sf in gemm_paper.FPGA_CHUNK_SWEEP]
                         + [(sf, 4096, 4096)
                            for sf in gemm_paper.FPGA_CHUNK_SWEEP]
                         + [(4096, 4096, 4096), (97, 200, 136), (1, 64, 64),
                            (300, 257, 1030), (40, 1024, 777)])
def test_gemm_plan(M, N, K):
    """The plan as a pure function: every planned f32 shape is compiled and
    fits the law; the grid has MIN_BLOCKS blocks or K is too short to split
    once more and the tile is the smallest; every hbb chunk of the sweep
    (1024² and the 4096² scaling run) fills the card; bf16 keeps the
    default block, unsplit; an explicit block shape is never split."""
    bm, bn, bk, splits = ops.plan(M, N, K, torch.float32)
    assert (bm, bn, bk) in ops.SHAPES and (bm, bn, bk) in ops.F32_TILES
    assert ops.smem_bytes(bm, bn, bk, 4) <= ops.SMEM_LIMIT
    assert splits >= 1 and splits & (splits - 1) == 0
    assert K // splits >= ops.MIN_SPLIT_K or splits == 1
    blocks = -(-M // bm) * -(-N // bn) * splits
    if blocks < ops.MIN_BLOCKS:       # why not: K too short to split more
        assert K // (2 * splits) < ops.MIN_SPLIT_K
        assert (bm, bn, bk) == ops.F32_TILES[-1]
    if (bm, bn, bk) != ops.F32_TILES[-1]:
        assert splits <= ops.MAX_SPLITS
    if N >= 1024 and K >= 1024 and M in gemm_paper.FPGA_CHUNK_SWEEP:
        assert blocks >= ops.MIN_BLOCKS
    assert bm <= max(M, ops.F32_TILES[-1][0])
    assert ops.plan(M, N, K, torch.bfloat16) == (ops.BM, ops.BN, ops.BK, 1)
    # on the host the kernel's plain version runs, planned or explicit
    _, (a, b) = _operands(min(M, 64), min(K, 96), min(N, 80), "float32",
                          seed=M)
    _close(ops.gemm(a, b), a.numpy() @ b.numpy(), TOL["float32"])


@pytest.mark.parametrize("block", sorted(ops.SHAPES))
def test_gemm_explicit_block_never_split(block):
    """An explicit block shape is launched as given with one split, so the
    Table 2 sweep measures what it names; no block shape follows the plan.
    The plain version runs on the host either way."""
    bm, bn, bk = block
    for dtype in (torch.float32, torch.bfloat16):
        assert ops.launch_shape(256, 1024, 1024, dtype, bm, bn, bk) == \
            (bm, bn, bk, 1)
        assert ops.launch_shape(256, 1024, 1024, dtype) == \
            ops.plan(256, 1024, 1024, dtype)
    assert ops.launch_shape(8, 1024, 1024, torch.float32, bn=bn) == \
        (ops.BM, bn, ops.BK, 1)
    _, (a, b) = _operands(40, 72, 48, "float32", seed=bn)
    _close(ops.gemm(a, b, bm=bm, bn=bn, bk=bk), a.numpy() @ b.numpy(),
           TOL["float32"])


@pytest.mark.parametrize("split", [0, 48, 128])
def test_matmul_row_split_matches_jax(split):
    (ja, jb), (a, b) = _operands(128, 64, 64, "float32", seed=3)
    want = jgemm_ops.matmul_row_split(ja, jb, split)
    got = ops.matmul_row_split(a, b, split)
    assert got.shape == (128, 64)
    _close(got, want, TOL["float32"])


# ------------------------------------------------------------ chunk laws
@settings(max_examples=200, deadline=None)
@given(S_f=st.integers(1, 4096), f=st.floats(0.01, 1000.0),
       r=st.integers(0, 10**6), n=st.integers(1, 64))
def test_cpu_chunk_matches_jax(S_f, f, r, n):
    assert chunking.cpu_chunk(S_f, f, r, n) == jchunk.cpu_chunk(S_f, f, r, n)


@settings(max_examples=100, deadline=None)
@given(S_f=st.integers(1, 4096), r=st.integers(0, 10**6))
def test_accelerator_chunk_matches_jax(S_f, r):
    c = chunking.accelerator_chunk(S_f, r)
    assert c == jchunk.accelerator_chunk(S_f, r)
    assert 0 <= c <= r and c <= S_f


@settings(max_examples=100, deadline=None)
@given(total=st.integers(1, 512).map(lambda x: x * 4),
       speeds=st.lists(st.floats(0.1, 50.0), min_size=1, max_size=8))
def test_proportional_split_matches_jax(total, speeds):
    parts = chunking.proportional_split(total, speeds, quantum=4)
    assert parts == jchunk.proportional_split(total, speeds, quantum=4)
    assert sum(parts) == total and all(p % 4 == 0 for p in parts)


# --------------------------------------------------------------- pipeline
class SimBody(Body):
    """Accelerator 8× faster than a core (tests/test_hbb.py::SimBody)."""

    def operatorCPU(self, b, e):
        time.sleep((e - b) * 2e-4)

    def operatorFPGA(self, b, e):
        time.sleep((e - b) * 2.5e-5)


def _run(ncc, nfc, n=8000, chunk=512, scheduler="dynamic"):
    p = Params(num_cpu_tokens=ncc, num_fpga_tokens=nfc, fpga_chunk=chunk,
               f0=4.0, scheduler=scheduler)
    return Dynamic(p).parallel_for(0, n, SimBody())


def _assert_exact_cover(rep, n):
    pos = 0
    for b, e in sorted((r.begin, r.end) for r in rep.records):
        assert b == pos and e > b
        pos = e
    assert pos == n


@pytest.mark.parametrize("ncc,nfc", [(2, 1), (0, 1), (2, 0)])
def test_parallel_for_exact_coverage(ncc, nfc):
    rep = _run(ncc, nfc, n=4000)
    _assert_exact_cover(rep, 4000)
    kinds = {r.resource: ("accelerator" if r.resource.startswith("FC")
                          else "core") for r in rep.records}
    assert sum(rep.iters_by_kind(kinds).values()) == 4000


class CountingBody(Body):
    """Counts every iteration it is handed, from any thread."""

    def __init__(self, n):
        self.hits = [0] * n

    def operatorCPU(self, b, e):
        for i in range(b, e):
            self.hits[i] += 1

    operatorFPGA = operatorCPU


def test_parallel_for_stress_exact_coverage():
    """More tokens than host cores and a 1 µs switch interval: stage S1's
    claim of the next chunk stays atomic, so every iteration runs exactly
    once and the records tile the space."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for seed in range(5):
            n = 5000 + 37 * seed
            body = CountingBody(n)
            p = Params(num_cpu_tokens=2 * (os.cpu_count() or 2),
                       num_fpga_tokens=2, fpga_chunk=16, f0=2.0)
            t0 = time.perf_counter()
            rep = Dynamic(p).parallel_for(0, n, body)
            assert time.perf_counter() - t0 < 30
            assert body.hits == [1] * n
            _assert_exact_cover(rep, n)
    finally:
        sys.setswitchinterval(old)


def test_f_converges_to_true_ratio():
    rep = _run(2, 1, n=20000)
    assert 5.0 < rep.f_final < 12.0         # true ratio 8


@pytest.mark.parametrize("scheduler", ["static", "oracle"])
def test_static_and_oracle_schedulers_match_jax_split(scheduler):
    """The static baselines split by proportional_split, as in JAX: even
    speeds (static) or the prior f0 for the accelerator (oracle)."""
    rep = _run(2, 1, n=8000, scheduler=scheduler)
    _assert_exact_cover(rep, 8000)
    jp = jhbb.Params(num_cpu_tokens=2, num_fpga_tokens=1, fpga_chunk=512,
                     f0=4.0, scheduler=scheduler)

    class Null(jhbb.Body):
        def operatorCPU(self, b, e):
            pass

        def operatorFPGA(self, b, e):
            pass

    jrep = jhbb.Dynamic(jp).parallel_for(0, 8000, Null())
    assert sorted((r.resource, r.begin, r.end) for r in rep.records) == \
        sorted((r.resource, r.begin, r.end) for r in jrep.records)
    assert rep.f_final == jrep.f_final == 4.0


def test_dynamic_get_instance_is_a_singleton_per_params():
    p = Params(num_cpu_tokens=1)
    assert Dynamic.get_instance(p) is Dynamic.get_instance(Params(
        num_cpu_tokens=1))
    assert Dynamic.get_instance(Params(num_cpu_tokens=3)).params.\
        num_cpu_tokens == 3
    with pytest.raises(ValueError):
        Dynamic(Params(num_cpu_tokens=0, num_fpga_tokens=0)).parallel_for(
            0, 10, SimBody())


def test_tracker_matches_jax():
    seq = [("acc", 64, 0.01), ("c0", 8, 0.02), ("c1", 4, 0.02),
           ("acc", 64, 0.004), ("c0", 2, 0.01), ("acc", 32, 0.02)]
    kinds = {"acc": "accelerator", "c0": "core", "c1": "core"}
    t, j = ThroughputTracker(kinds, f0=3.0), JThroughputTracker(kinds, f0=3.0)
    assert t.f() == j.f() == 3.0
    for name, n, dt in seq:
        t.record(name, n, dt)
        j.record(name, n, dt)
        assert t.f() == pytest.approx(j.f(), rel=1e-12)
    for name in kinds:
        assert t.throughput(name) == pytest.approx(j.throughput(name),
                                                   rel=1e-12)
    ts, js = t.snapshot(), j.snapshot()
    assert set(ts) == set(js)
    for name in ts:
        assert (ts[name].kind, ts[name].n_chunks, ts[name].iters_done) == \
            (js[name].kind, js[name].n_chunks, js[name].iters_done)
        assert ts[name].ewma_thr == pytest.approx(js[name].ewma_thr)
        assert ts[name].busy_time == pytest.approx(js[name].busy_time)
    t.record("acc", 1, 1.0)                 # a snapshot is a copy
    assert ts["acc"].n_chunks == js["acc"].n_chunks


# -------------------------------------------------------------- straggler
def test_straggler_monitor_matches_jax():
    """tests/test_hbb.py's degrading-tier sequence, fed to both monitors:
    the same flags, exclusions and speeds after every observation."""
    t = StragglerMonitor(beta=0.5, patience=2)
    j = JStragglerMonitor(beta=0.5, patience=2)
    for step in range(6):
        for tier, dt in (("t0", 0.1), ("t1", 0.1),
                         ("t2", 1.0 if step >= 2 else 0.1)):
            t.observe(tier, 100, dt)
            j.observe(tier, 100, dt)
            assert t.stragglers() == j.stragglers()
            assert t.excluded() == j.excluded()
            assert t.relative_speeds() == pytest.approx(j.relative_speeds())
            assert {n: h.flags for n, h in t.tiers.items()} == \
                {n: h.flags for n, h in j.tiers.items()}
    assert t.excluded() == ["t2"]
    assert set(t.relative_speeds()) == {"t0", "t1"}


def test_straggler_recovers_flags():
    mon = StragglerMonitor(beta=0.5, patience=5)
    mon.observe("a", 100, 0.1)
    mon.observe("b", 100, 1.0)      # slow once
    mon.observe("b", 100, 0.01)     # recovers (EWMA pulls back fast)
    mon.observe("b", 100, 0.01)
    assert mon.excluded() == []


# ----------------------------------------------------------------- energy
def test_run_energy_matches_jax():
    recs = [("FC0", 0, 64, 0.0, 0.010), ("CC0", 64, 72, 0.0, 0.012),
            ("CC1", 72, 80, 0.001, 0.011), ("FC0", 80, 144, 0.010, 0.019)]
    rep = RunReport(records=[ChunkRecord(*r) for r in recs], wall_time=0.02,
                    f_final=7.5)
    jrep = jhbb.RunReport(records=[jhbb.ChunkRecord(*r) for r in recs],
                          wall_time=0.02, f_final=7.5)
    kinds = {"FC0": "accelerator", "CC0": "core", "CC1": "core"}
    assert "tpu-v5e" not in energy.POWER_MODELS      # a TPU figure: left out
    assert set(energy.POWER_MODELS) == {"zynq-z7020", "zynq-ultrascale-zu9"}
    for name, pm in energy.POWER_MODELS.items():
        assert vars(pm) == vars(jenergy.POWER_MODELS[name])
        e, p = energy.run_energy(rep, kinds, pm)
        je, jp = jenergy.run_energy(jrep, kinds, jenergy.POWER_MODELS[name])
        assert (e, p) == pytest.approx((je, jp), rel=1e-12)
    assert rep.busy_time("FC0") == pytest.approx(jrep.busy_time("FC0"))


# ------------------------------------------------------------ partitioner
def _grad_fn(params, batch):
    """Torch gradient stand-in: every leaf the batch mean; the work (a
    sleep per sample) makes the service time proportional to the slice."""
    time.sleep(2e-4 * len(batch["x"]))
    return {n: torch.full_like(p, float(batch["x"].mean()))
            for n, p in params.items()}, {}


def test_partitioner_weighted_mean_equals_even_split():
    """The partitioner half of tests/test_sharding.py: two tiers, one
    slowed 3×; after warm-up the fast tier gets more samples, and the
    sample-weighted combine equals the global mean for any split."""
    params = {"w": torch.zeros(4)}
    tiers = [Tier("fast", ["cpu"] * 6, _grad_fn, slowdown=1.0),
             Tier("slow", ["cpu"] * 2, _grad_fn, slowdown=3.0)]
    part = HeterogeneousBatchPartitioner(tiers, quantum=2)
    batch = {"x": torch.arange(24, dtype=torch.float32)}
    for _ in range(6):
        g, info = part.step(params, batch)
    assert info["parts"][0] > info["parts"][1], info
    assert sum(info["parts"]) == 24
    assert abs(float(g["w"][0]) - float(batch["x"].mean())) < 1e-5


def test_partitioner_split_matches_jax():
    """Both partitioners, their monitors fed the same observations, split a
    batch the same way — exclusions included."""
    from repro.core.partitioner import HeterogeneousBatchPartitioner as JP
    from repro.core.partitioner import Tier as JTier
    names = ["a", "b", "c"]
    t = HeterogeneousBatchPartitioner([Tier(n, [], _grad_fn) for n in names],
                                      quantum=2)
    j = JP([JTier(n, [], _grad_fn) for n in names], quantum=2)
    for step in range(5):
        for n, dt in (("a", 0.1), ("b", 0.3), ("c", 2.0 if step else 0.1)):
            t.monitor.observe(n, 10, dt)
            j.monitor.observe(n, 10, dt)
        assert t.split(64) == j.split(64)
    assert t.split(64)[2] == 0                      # c was excluded


# ------------------------------------------------------------- the driver
def test_hetero_gemm_driver_on_cpu():
    """The Fig. 5 sweep on device="cpu" at a small size: every config's C
    equals the plain product (the driver's own check, within 1e-5 of the
    largest value, and here to 1e-4 absolute), and the rows split by class
    cover C exactly."""
    rows = hetero_gemm.fig5(96, 2, (8, 32), device="cpu",
                            printer=lambda s: None)
    assert [(r.ncc, r.nfc, r.chunk) for r in rows] == \
        [(2, 0, 8), (0, 1, 8), (0, 1, 32), (2, 1, 8), (2, 1, 32)]
    for r in rows:
        assert r.ok and r.max_err < 1e-4
        assert sum(r.rows_by_class().values()) == 96
        _assert_exact_cover(r.report, 96)
    t_off, t_het, red = hetero_gemm.reduction(rows)
    assert t_off > 0 and t_het > 0 and red == 1 - t_het / t_off
    assert hetero_gemm.main(["--n", "64", "--ncc", "1", "--chunks", "16",
                             "--device", "cpu"]) == 0


def test_hetero_gemm_driver_needs_the_card_or_an_explicit_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        hetero_gemm.fig5(32, 1, (8,))


def test_gemm_paper_config_matches_jax():
    from repro.configs import gemm_paper as jgp
    assert gemm_paper.PLATFORMS == {
        k: gemm_paper.Platform(**vars(v)) for k, v in jgp.PLATFORMS.items()}
    assert (gemm_paper.GEMM_N_MAIN, gemm_paper.GEMM_N_SCALING,
            gemm_paper.FPGA_CHUNK_SWEEP) == (jgp.GEMM_N_MAIN,
                                             jgp.GEMM_N_SCALING,
                                             jgp.FPGA_CHUNK_SWEEP)
