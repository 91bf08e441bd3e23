"""The port's sharded serving path over gloo ranks on the CPU, against the
port on one device and against JAX's engine on a (1, 4) mesh.

Ranks are spawned processes (``launch/mesh.py::spawn_ranks``) that meet
through a ``file://`` store under the test's own temporary directory, so
concurrent test workers never share a port. One spawn per mesh size (2
and 4 ranks) runs every case (``test_torch_sharded_cases.py``) and saves
each rank's results; the tests hold them against the one-device port.
JAX's sharded engine runs once, in one subprocess with four host devices
and Auto axes (its default Explicit axes raise at
``repro/sharding/axes.py:88``). The models are the smoke
configs of mistral-nemo-12b and phi3.5-moe-42b widened to 16 heads over 4
KV heads (the full models' group of 4), so that both heads and KV heads
divide a 4-rank model axis; f32 throughout."""
import dataclasses
import os
import pickle
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from repro.configs import all_configs, smoke_config
from repro.models.model import model_defs
from repro.sharding import params as prm
from repro_torch.launch import serve as serve_mod
from repro_torch.launch.mesh import spawn_ranks
from repro_torch.models.moe import moe_block, moe_decode
from repro_torch.models.transformer import lm_hidden
from repro_torch.params import params_from_numpy
from repro_torch.serve import decode as tdec
from repro_torch.serve.prefill import prefill
from test_torch_sharded_cases import (ARCHS, ENGINE_KW, LENS, MAX_NEW,
                                      MESHES, PINNED_F, RANK_TIMEOUT,
                                      SAMPLED, WIDE, _decode_inputs,
                                      _flash_inputs, _moe_inputs,
                                      _prefill_inputs, _rank_cases,
                                      _rank_skewed, _serve, tcfg)

RTOL = ATOL = 2e-5      # f32 round-off (the JAX script's tolerance)
LOGIT_RTOL = 1e-5


def _jcfg(arch):
    return dataclasses.replace(smoke_config(all_configs()[arch]), **WIDE)


# -------------------------------------------------------------- fixtures
_ORACLE = textwrap.dedent("""
    import dataclasses, os, sys
    # four host devices on one thread, compiled at XLA's lowest
    # optimization level (most of the oracle's time is compiling; f32
    # agrees to rounding)
    os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=4 "
                               "--xla_cpu_multi_thread_eigen=false "
                               "--xla_backend_optimization_level=0 "
                               "--xla_llvm_disable_expensive_passes=true")
    import jax, numpy as np
    from jax.sharding import AxisType
    from repro.configs import all_configs, smoke_config
    from repro.serve.engine import Request, make_engine
    from repro.sharding.axes import ShardCtx

    archs, wide, kw, lens, max_new, f = eval(sys.argv[2])
    mesh = jax.make_mesh((1, 4), ("data", "model"),
                         axis_types=(AxisType.Auto, AxisType.Auto))
    ctx = ShardCtx(mesh=mesh)
    out = {}
    for arch in archs:
        cfg = dataclasses.replace(smoke_config(all_configs()[arch]), **wide)
        rng = np.random.default_rng(3)
        prompts = [rng.integers(0, cfg.vocab, n).tolist() for n in lens]
        eng = make_engine(cfg, ctx, **kw)
        eng.tracker.f = lambda: f
        reqs = [Request(rid=i, prompt=p, max_new=max_new)
                for i, p in enumerate(prompts)]
        eng.run(reqs)
        assert all(r.done for r in reqs)
        for r in reqs:
            out[f"{arch}/{r.rid}"] = np.asarray(r.out)
    np.savez(sys.argv[1], **out)
""")


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """JAX's parameters of both models (pickled for the ranks); JAX's
    sharded engine in a subprocess on one thread, beside the ranks of
    each mesh size and then the launcher over 2 ranks, which run one
    after another (the ranks of a spawn take a core each); the one-device
    engine's greedy and sampled streams."""
    d = tmp_path_factory.mktemp("sharded")
    trees, params = {}, {}
    for arch in ARCHS:
        jcfg, cfg = _jcfg(arch), tcfg(arch)
        jp = jax.tree.map(np.asarray, prm.materialize(
            model_defs(jcfg), jax.random.PRNGKey(0)))
        trees[arch] = jp
        params[arch] = params_from_numpy(jp, cfg, "cpu")
    params_path = str(d / "params.pkl")
    with open(params_path, "wb") as f:
        pickle.dump(trees, f)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    oracle_out = str(d / "oracle.npz")
    args = repr((ARCHS, WIDE, ENGINE_KW, LENS, MAX_NEW, PINNED_F))
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"),
               JAX_PLATFORMS="cpu")
    pipes = dict(stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                 env=env, cwd=root)
    oracle = subprocess.Popen([sys.executable, "-c", _ORACLE, oracle_out,
                               args], **pipes)
    try:
        for m in MESHES:
            spawn_ranks(_rank_cases, m, params_path, str(d),
                        device_type="cpu",
                        init_method=f"file://{d}/store_{m}",
                        timeout=RANK_TIMEOUT)
        launched = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.serve", "--device",
             "cpu", "--model-parallel", "2"], timeout=RANK_TIMEOUT,
            **pipes)
        _, err = oracle.communicate(timeout=RANK_TIMEOUT)
    finally:
        oracle.kill()
    assert launched.returncode == 0, launched.stderr[-3000:]
    assert oracle.returncode == 0, err[-3000:]
    ranks = {m: [torch.load(d / f"m{m}_r{i}.pt", weights_only=False)
                 for i in range(m)] for m in MESHES}
    with np.load(oracle_out) as z:
        jax_streams = {k: z[k].tolist() for k in z.files}
    one = {arch: _serve(tcfg(arch), params[arch]) for arch in ARCHS}
    sampled = _serve(tcfg(ARCHS[0]), params[ARCHS[0]], **SAMPLED)
    return dict(params=params, ranks=ranks, jax=jax_streams, dir=d,
                params_path=params_path, launched=launched.stdout, one=one,
                sampled=sampled)


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(torch.as_tensor(got).numpy(),
                               torch.as_tensor(want).numpy(), rtol=rtol,
                               atol=atol)


def _whole_pool(parts):
    """The ranks' offsets (N, ps/m, …) of a pool → (N, ps, …)."""
    return torch.cat(parts, dim=1)


# ----------------------------------------------------------------- tests
@pytest.mark.parametrize("m", MESHES)
def test_collectives_over_gloo_ranks(run, m):
    xs = [torch.arange(24.0).reshape(2, 3, 4) + 100 * i for i in range(m)]
    for i, rank in enumerate(run["ranks"][m]):
        r = rank["collectives"]
        assert r["coords"] == (1, m, i, {"data": 0, "model": i})
        assert torch.equal(r["gather0"], torch.cat(xs, 0))
        assert torch.equal(r["gather1"], torch.cat(xs, 1))
        assert torch.equal(r["gather_last"], torch.cat(xs, -1))
        assert torch.equal(r["sum"], sum(xs))
        assert torch.equal(r["max"], -xs[0])
        assert torch.equal(r["x_kept"], xs[i])
        assert torch.equal(r["bcast"], torch.zeros(3))
        assert "meta tensor cannot take a gloo" in r["refused"]


@pytest.mark.parametrize("m", MESHES)
def test_flash_decode_gqa_sharded_matches_one_device(run, m):
    fi = _flash_inputs()
    t = {k: torch.from_numpy(v.copy()) for k, v in fi.items()}
    o, pk, pv = tdec.flash_decode_gqa(
        t["q"], t["kn"], t["vn"], t["pk"], t["pv"], t["pos"], scale=0.25,
        softcap=0.0, page_table=t["pt"])
    outs = [r["flash"] for r in run["ranks"][m]]
    for got in outs:                       # every rank holds the whole row
        _close(got[0], o)
    # the pools outside the trash page 0: the new rows on the owning rank
    _close(_whole_pool([g[1] for g in outs])[1:], pk[1:], 0, 0)
    _close(_whole_pool([g[2] for g in outs])[1:], pv[1:], 0, 0)


@pytest.mark.parametrize("m", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_sharded_matches_one_device(run, arch, m):
    cfg = tcfg(arch)
    toks, lens = _prefill_inputs(cfg.vocab)
    with torch.no_grad():
        logits, cache = prefill(cfg, run["params"][arch],
                                torch.from_numpy(toks),
                                prompt_len=torch.from_numpy(lens),
                                page_size=8)
    ranks = run["ranks"][m]
    for r in ranks:
        _close(r[f"{arch}/prefill"][0], logits, LOGIT_RTOL, LOGIT_RTOL)
    # rank i's rows are its in-page offsets of each 8-row page
    for li, layer in enumerate(cache["layers"]):
        for n, rows in layer.items():
            B, S = rows.shape[:2]
            parts = [r[f"{arch}/prefill"][1][li][n].reshape(
                B, S // 8, 8 // m, *rows.shape[2:]) for r in ranks]
            _close(torch.cat(parts, dim=2).reshape(rows.shape), rows)


@pytest.mark.parametrize("m", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_lm_hidden_sharded_matches_one_device(run, arch, m):
    """The stack's final hidden states and summed router stats (forward,
    no gradient) over the ranks' blocks against one device."""
    cfg = tcfg(arch)
    toks, _ = _prefill_inputs(cfg.vocab)
    with torch.no_grad():
        h, stats = lm_hidden(cfg, run["params"][arch], torch.from_numpy(toks))
    for r in run["ranks"][m]:
        got_h, got_stats = r[f"{arch}/hidden"]
        _close(got_h, h)
        if stats is None:
            assert got_stats is None
        else:                # the router sees the stream to round-off
            _close(got_stats, stats)


@pytest.mark.parametrize("m", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_sharded_matches_one_device(run, arch, m):
    cfg = tcfg(arch)
    pools, pt, pos, toks = _decode_inputs(cfg)
    tcache = {"layers": [{n: torch.from_numpy(a.copy()) for n, a in l.items()}
                         for l in pools]}
    with torch.no_grad():
        logits, tcache = tdec.decode_step(
            cfg, run["params"][arch], tcache, torch.from_numpy(toks),
            torch.from_numpy(pos), torch.from_numpy(pt))
    ranks = run["ranks"][m]
    for r in ranks:
        _close(r[f"{arch}/decode"][0], logits, LOGIT_RTOL, LOGIT_RTOL)
    for li, layer in enumerate(tcache["layers"]):
        for n, pool in layer.items():
            got = _whole_pool([r[f"{arch}/decode"][1][li][n] for r in ranks])
            _close(got[1:], pool[1:])


@pytest.mark.parametrize("m", MESHES)
def test_moe_expert_parallel_matches_one_device(run, m):
    arch = ARCHS[1]
    cfg = tcfg(arch)
    xb, xd = (torch.from_numpy(a) for a in _moe_inputs(cfg))
    p = run["params"][arch]["layers"][0]["moe"]
    with torch.no_grad():
        out, stats = moe_block(cfg, p, xb)
        dec = moe_decode(cfg, p, xd)
    for r in run["ranks"][m]:
        (got, got_stats), got_dec = r[f"{arch}/moe"]
        _close(got, out)
        _close(got_stats, stats, 0, 0)      # routing is whole on each rank
        _close(got_dec, dec)


@pytest.mark.parametrize("m", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_engine_streams_match_one_device_and_jax(run, arch, m):
    one = run["one"][arch]
    assert all(len(s) == MAX_NEW for s in one)
    jax_streams = [run["jax"][f"{arch}/{i}"] for i in range(len(LENS))]
    assert one == jax_streams
    for r in run["ranks"][m]:
        assert r[f"{arch}/streams"] == one


@pytest.mark.parametrize("m", MESHES)
def test_sampled_streams_match_one_device(run, m):
    """Sampling on the device: every rank's generator is seeded alike and
    draws over the same whole logits, so the ranks emit the one-device
    engine's sampled streams."""
    one = run["sampled"]
    assert one != run["one"][ARCHS[0]]                 # not greedy
    for r in run["ranks"][m]:
        assert r["sampled"] == one


def test_skewed_clock_admits_the_same_groups(run):
    """Rank 1's clock reads slower than rank 0's: its own ratio f drifts
    from rank 0's, but the ranks admit the same groups (rank 0's f is
    broadcast) and finish with the same streams, within the timeout."""
    d = run["dir"]
    spawn_ranks(_rank_skewed, 2, run["params_path"], str(d),
                device_type="cpu", init_method=f"file://{d}/store_skew",
                timeout=RANK_TIMEOUT)
    r0, r1 = (torch.load(d / f"skew_r{i}.pt", weights_only=False)
              for i in range(2))
    assert r0["own_f"] != r1["own_f"]          # the skew moved rank 1's f
    assert r0["admitted"] == r1["admitted"]
    assert sum(r0["admitted"]) == 3 * len(LENS)
    assert r0["streams"] == r1["streams"]
    assert all(len(s) == MAX_NEW for s in r0["streams"])


def test_launcher_model_parallel_prints_one_rank_streams(run, capsys):
    """``launch.serve --model-parallel 2`` (two spawned gloo ranks, rank 0
    printing) serves the launcher's workload with the streams of the
    one-rank launcher."""
    serve_mod.main(["--device", "cpu"])
    one = capsys.readouterr().out.splitlines()
    got = run["launched"].splitlines()
    assert "over 2 ranks" in got[0]
    assert got[1:] == one[1:] and len(one) == 5
