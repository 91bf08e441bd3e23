"""The port's training of MoE, MLA and Mamba-2 models on the CPU, held
against the JAX package: the loss, ``moe_aux`` and every gradient leaf
against ``jax.value_and_grad(loss_fn)`` for the phi3.5-moe (GQA + MoE),
deepseek-v2 (MLA + MoE with a shared expert and a dense first layer) and
mamba2 smoke configs, three train steps against ``jax.jit(make_train_step)``
on a state built by hand, ``moe_block`` with the aux loss against
``jax.grad``, and the backward of the grouped GEMM (:class:`GroupedGemm`)
and of the SSD intra-chunk (:class:`SsdIntraChunk`) against autograd
through their plain versions. Parameters come from the JAX initializer,
inputs from numpy seeds."""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

from repro.configs import all_configs, smoke_config
from repro.configs.base import MoECfg as JMoECfg
from repro.configs.base import ModelConfig as JModelConfig
from repro.models import moe as jmoe
from repro.models.model import loss_fn as jloss_fn
from repro.models.model import model_defs
from repro.models.transformer import lm_hidden as jlm_hidden
from repro.sharding import params as prm
from repro.sharding.axes import ShardCtx
from repro.train.optimizer import OptConfig as JOpt
from repro.train.optimizer import init_moments as jinit_moments
from repro.train.step import make_train_step as jmake_train_step
from repro_torch import configs as tconfigs
from repro_torch.configs.base import MoECfg, ModelConfig
from repro_torch.kernels.grouped_gemm import ops as gg_ops
from repro_torch.kernels.grouped_gemm import ref as gg_ref
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.kernels.ssd import ref as ssd_ref
from repro_torch.launch import train as tlaunch
from repro_torch.models import moe as tmoe
from repro_torch.models.model import loss_fn
from repro_torch.models.transformer import lm_hidden
from repro_torch.params import params_from_numpy, tree_leaves
from repro_torch.train import checkpoint
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.step import make_state, make_train_step
# the JAX oracles compile at XLA's lowest optimization level (most of
# their time is compiling; f32 results agree to rounding)
from test_torch_variants import _jit

ROOT = Path(__file__).resolve().parents[1]
PHI, DEEPSEEK, MAMBA2 = ("phi3.5-moe-42b-a6.6b", "deepseek-v2-236b",
                         "mamba2-130m")
ARCHS = [PHI, DEEPSEEK, MAMBA2]
# tests/test_torch_train.py's tolerances: f32 the same formulas in another
# sum order; bf16 both frameworks round every product to bf16, at other
# places
GRAD_TOL = {"float32": 1e-4, "bfloat16": 3e-2}
LOSS_TOL = {"float32": 1e-5, "bfloat16": 1e-3}


@pytest.fixture(scope="module")
def auto_ctx():
    """The oracle's mesh: 1×1 with Auto axes. On the default Explicit-axis
    ``single_device_ctx()`` the MoE models' gradient is red: the cotangent
    that leaves the MoE ``shard_map`` carries Explicit ('data', 'model')
    sharding, and ``_attend_bwd``'s ``dynamic_update_slice`` into its
    unsharded dq/dk/dv accumulators raises a ``ShardingTypeError``
    (``repro/models/attention.py:275-283``)."""
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         devices=jax.devices()[:1],
                         axis_types=(AxisType.Auto, AxisType.Auto))
    return ShardCtx(mesh=mesh)


def _cfgs(arch, dtype):
    j = dataclasses.replace(smoke_config(all_configs()[arch]),
                            param_dtype=dtype)
    t = dataclasses.replace(tconfigs.smoke_config(tconfigs.get_config(arch)),
                            param_dtype=dtype)
    return j, t


def _batch(vocab, B=4, S=32, seed=0):
    toks = np.random.default_rng(seed).integers(0, vocab, (B, S + 1))
    toks = toks.astype(np.int32)
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:],
            "mask": np.ones((B, S), np.float32)}


def _to_port(tree, tcfg):
    return params_from_numpy(jax.tree.map(np.asarray, tree), tcfg,
                             device="cpu")


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _rel(a, b) -> float:
    a, b = a.detach().float(), b.detach().float()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


# ---------------------------------------------------- loss and gradients
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax(auto_ctx, arch, dtype):
    """Every leaf, the experts, router and shared experts included.

    Routing is discontinuous: where two experts' probabilities nearly tie,
    a one-ulp bf16 difference (the frameworks round a bf16 MLP's silu and
    products at other places) sends a token to another expert and moves
    its whole gradient. At batch seed 0 the bf16 deepseek smoke model
    routes 1 of 256 slots apart, at seeds 2 and 3 phi 2 and 1. So the
    batch is seed 1, where both route every slot alike in both dtypes,
    and the test first holds that: the summed slot fractions of the MoE
    layers (multiples of 1/(T·k), exact in both) are equal.

    Each gradient leaf within GRAD_TOL of its largest value of JAX's; in
    bf16, where JAX's own bf16 gradient is farther than that from the f32
    gradient at the same weights, the port's no farther from it than
    JAX's."""
    jcfg, tcfg = _cfgs(arch, dtype)
    jp = prm.materialize(model_defs(jcfg), jax.random.PRNGKey(0))
    batch = _batch(jcfg.vocab, seed=1)
    (jl, jm), jg = _jit(jax.value_and_grad(
        lambda p, b: jloss_fn(jcfg, p, b, auto_ctx), has_aux=True))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    tp = make_state(_to_port(jp, tcfg))["params"]
    if jcfg.moe is not None:
        jstats = _jit(lambda p, t: jlm_hidden(jcfg, p, t, auto_ctx)[1])(
            jp, jnp.asarray(batch["tokens"]))
        with torch.no_grad():
            _, stats = lm_hidden(tcfg, tp, _torch_batch(batch)["tokens"])
        assert torch.equal(stats[1], torch.from_numpy(np.asarray(jstats[1])))
    loss, metrics = loss_fn(tcfg, tp, _torch_batch(batch))
    grads = torch.autograd.grad(loss, tree_leaves(tp))
    assert set(metrics) == set(jm)
    assert abs(loss.item() - float(jl)) <= LOSS_TOL[dtype] * float(jl)
    if "moe_aux" in jm:
        assert float(jm["moe_aux"]) > 0
        assert abs(float(metrics["moe_aux"]) - float(jm["moe_aux"])) <= \
            LOSS_TOL[dtype] * float(jm["moe_aux"])
    want = tree_leaves(_to_port(jg, tcfg))
    assert len(grads) == len(want)
    truth = want
    if dtype == "bfloat16":
        # the f32 gradient at the same (bf16) weights: where the reference's
        # own bf16 gradient lies farther than GRAD_TOL from it (mamba2: up
        # to 3.4e-2 at this batch), the port's must lie no farther
        jcfg32, tcfg32 = _cfgs(arch, "float32")
        jp32 = jax.tree.map(lambda x: x.astype(jnp.float32), jp)
        _, jg32 = _jit(jax.value_and_grad(
            lambda p, b: jloss_fn(jcfg32, p, b, auto_ctx), has_aux=True))(
            jp32, {k: jnp.asarray(v) for k, v in batch.items()})
        truth = tree_leaves(_to_port(jg32, tcfg32))
    for g, w, t, p in zip(grads, want, truth, tree_leaves(tp)):
        assert g.dtype == p.dtype and g.shape == p.shape
        err = _rel(g, w)
        assert err < GRAD_TOL[dtype] or _rel(g, t) <= _rel(w, t), \
            (tuple(g.shape), err, _rel(g, t), _rel(w, t))


# ------------------------------------------------------------ train step
@pytest.mark.parametrize("arch,mb,moments", [
    (PHI, 1, "float32"), (PHI, 2, "float32"), (DEEPSEEK, 1, "float32"),
    (DEEPSEEK, 2, "float32"), (DEEPSEEK, 1, "int8"), (MAMBA2, 1, "float32"),
    (MAMBA2, 2, "float32")])
def test_train_steps_match_jax(auto_ctx, arch, mb, moments):
    """Three f32 steps (the first at lr 0 of the warmup) against the jitted
    JAX step, with ``test_torch_train.py::test_train_steps_match_jax``'s
    bounds: losses to 1e-4 relative, params to 2.5·lr at most (a near-zero
    gradient can flip the sign of Adam's first update) and 1e-6 in the
    median."""
    jcfg, tcfg = _cfgs(arch, "float32")
    kw = dict(lr=1e-3, warmup_steps=1, decay_steps=10, moments_dtype=moments)
    jo, to = JOpt(**kw), OptConfig(**kw)
    jp = prm.materialize(model_defs(jcfg), jax.random.PRNGKey(0))
    mom = jinit_moments(jp, jo)
    jstate = {"params": jp, "m": mom["m"], "v": mom["v"],
              "step": jnp.zeros((), jnp.int32)}
    tstate = make_state(_to_port(jp, tcfg), to)
    jstep = _jit(jmake_train_step(jcfg, jo, auto_ctx, microbatches=mb))
    tstep = make_train_step(tcfg, to, microbatches=mb)
    batch = _batch(jcfg.vocab)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    for _ in range(3):
        jstate, jm = jstep(jstate, jb)
        tstate, tm = tstep(tstate, _torch_batch(batch))
        assert set(tm) == set(jm)
        assert abs(float(tm["loss"]) - float(jm["loss"])) <= \
            1e-4 * float(jm["loss"])
    assert tstate["step"] == 3
    diff = torch.cat([(a.detach() - b).abs().reshape(-1) for a, b in zip(
        tree_leaves(tstate["params"]),
        tree_leaves(_to_port(jstate["params"], tcfg)))])
    assert float(diff.max()) <= 2.5 * to.lr
    assert float(diff.median()) < 1e-6


# ------------------------------------------------ MoE block and aux loss
def _moe_cfgs(cf, n_shared):
    """tests/test_moe.py's config, in both packages."""
    kw = dict(name="moe-test", family="moe", n_layers=2, d_model=32,
              n_heads=4, n_kv_heads=2, head_dim=8, d_ff=64, vocab=64,
              act="swiglu", param_dtype="float32")
    mk = dict(n_experts=8, top_k=2, d_expert=48, n_shared=n_shared,
              capacity_factor=cf)
    return (JModelConfig(moe=JMoECfg(**mk), **kw),
            ModelConfig(moe=MoECfg(**mk), **kw))


@pytest.mark.parametrize("cf,n_shared", [(16.0, 0), (16.0, 1), (0.1, 0),
                                         (1.25, 1)])
def test_moe_block_and_aux_grads_match_jax(auto_ctx, cf, n_shared):
    """d(Σ out·r + aux)/d(x, every expert leaf) against ``jax.grad`` of JAX's
    ``moe_block`` and ``aux_loss_from_stats``; cf 0.1 and 1.25 drop tokens
    at this size."""
    jcfg, tcfg = _moe_cfgs(cf, n_shared)
    jp = prm.materialize(jmoe.moe_defs(jcfg), jax.random.PRNGKey(0))
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 32, 32)).astype(np.float32)
    r = rng.normal(size=(2, 32, 32)).astype(np.float32)

    def jf(p, x):
        out, stats = jmoe.moe_block(jcfg, p, x, auto_ctx)
        return jnp.sum(out * r) + jmoe.aux_loss_from_stats(jcfg, stats)

    jgp, jgx = _jit(jax.grad(jf, argnums=(0, 1)))(jp, jnp.asarray(x))
    tp = {n: torch.from_numpy(np.asarray(v)).requires_grad_()
          for n, v in jp.items()}
    tx = torch.from_numpy(x).requires_grad_()
    out, stats = tmoe.moe_block(tcfg, tp, tx)
    aux = tmoe.aux_loss_from_stats(tcfg, stats)
    jaux = jmoe.aux_loss_from_stats(jcfg, jmoe.moe_block(
        jcfg, jp, jnp.asarray(x), auto_ctx)[1])
    assert abs(float(aux) - float(jaux)) <= 1e-6
    names = sorted(tp)
    got = torch.autograd.grad(torch.sum(out * torch.from_numpy(r)) + aux,
                              [tx] + [tp[n] for n in names])
    for g, w, what in zip(got, [jgx] + [jgp[n] for n in names],
                          ["x"] + names):
        assert _rel(g, torch.from_numpy(np.asarray(w))) < 1e-4, what
    Ce = tmoe.capacity(tcfg, 64)
    dropped = int((torch.round(stats[1] * 128) - Ce).clamp(min=0).sum())
    assert (dropped > 0) == (cf < 8), dropped


def test_aux_loss_has_no_gradient_through_the_fractions():
    _, tcfg = _moe_cfgs(1.25, 0)
    stats = torch.rand((3, 2, 8), requires_grad=True)
    aux = tmoe.aux_loss_from_stats(tcfg, stats)
    g, = torch.autograd.grad(aux, stats)
    assert float(g[:, 1].abs().max()) == 0.0
    want = tcfg.moe.aux_weight * 8 * stats.detach()[:, 1].mean(0) / 3
    torch.testing.assert_close(g[:, 0], want.expand(3, 8))


# ------------------------------------------------- kernels' backwards
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,stride0", [(64, False), (13, False),
                                       (5, True)])
def test_grouped_gemm_grads_match_plain(dtype, M, stride0):
    """:class:`GroupedGemm`'s dA and dW against autograd through
    ``grouped_gemm_ref``: an M (an expert's capacity) that is not a
    multiple of 8 (bf16 pads dW's sum with zero rows) and decode's
    stride-0 operand."""
    E, K, N = 4, 32, 24
    g = torch.Generator().manual_seed(M)
    if stride0:
        a = torch.randn((M, K), generator=g).to(dtype).unsqueeze(0).expand(
            E, M, K)
    else:
        a = torch.randn((E, M, K), generator=g).to(dtype)
    w = (torch.randn((E, K, N), generator=g) * K ** -0.5).to(dtype)
    dc = torch.randn((E, M, N), generator=g).to(dtype)
    a1, w1 = a.detach().requires_grad_(), w.detach().requires_grad_()
    out = gg_ops.grouped_gemm_autograd(a1, w1)
    da, dw = torch.autograd.grad(out, (a1, w1), dc)
    a2, w2 = a.detach().requires_grad_(), w.detach().requires_grad_()
    want = torch.autograd.grad(gg_ref.grouped_gemm_ref(a2, w2), (a2, w2), dc)
    torch.testing.assert_close(out, gg_ref.grouped_gemm_ref(a, w))
    tol = GRAD_TOL["bfloat16" if dtype == torch.bfloat16 else "float32"]
    for got, ref in zip((da, dw), want):
        assert got.dtype == dtype and got.shape == ref.shape
        assert _rel(got, ref) < tol


def test_grouped_gemm_backward_pads_only_the_sum():
    """The bf16 dW's zero rows change no value: equal to the f32 product of
    the same bf16 operands, rounded once."""
    E, M, K, N = 3, 11, 16, 8
    g = torch.Generator().manual_seed(0)
    a = torch.randn((E, M, K), generator=g).bfloat16().requires_grad_()
    w = torch.randn((E, K, N), generator=g).bfloat16().requires_grad_()
    dc = torch.randn((E, M, N), generator=g).bfloat16()
    _, dw = torch.autograd.grad(gg_ops.GroupedGemm.apply(a, w), (a, w), dc)
    want = torch.einsum("emk,emn->ekn", a.detach().float(),
                        dc.float()).bfloat16()
    assert torch.equal(dw, want)
    only_w = gg_ops.GroupedGemm.apply(a.detach(), w)
    assert torch.autograd.grad(only_w, w, dc)[0].shape == w.shape


@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("Q", [16, 13])
def test_ssd_intra_chunk_grads_match_plain(shared, Q):
    """:class:`SsdIntraChunk`'s gradients against autograd through
    ``ssd_intra_chunk_ref``, with B and C shared by the heads (stride 0,
    as ``ssd_scan`` passes them: their gradients summed over the heads) or
    per head."""
    G, H, P, N = 3, 4, 8, 6
    g = torch.Generator().manual_seed(Q)
    x = torch.randn((G, H, Q, P), generator=g, dtype=torch.float64)
    cs = torch.cumsum(-torch.rand((G, H, Q), generator=g,
                                  dtype=torch.float64), -1)
    if shared:
        Bm, Cm = (torch.randn((G, 1, Q, N), generator=g, dtype=torch.float64)
                  for _ in range(2))
    else:
        Bm, Cm = (torch.randn((G, H, Q, N), generator=g, dtype=torch.float64)
                  for _ in range(2))
    dy = torch.randn((G, H, Q, P), generator=g, dtype=torch.float64)
    dst = torch.randn((G, H, N, P), generator=g, dtype=torch.float64)
    grads = []
    for fn in (ssd_ops.intra_chunk_autograd, ssd_ref.ssd_intra_chunk_ref):
        leaves = [t.float().requires_grad_() for t in (x, cs, Bm, Cm)]
        bb, cc = (t.expand(G, H, Q, N) for t in leaves[2:])
        y, st = fn(leaves[0], leaves[1], bb, cc)
        grads.append(torch.autograd.grad((y, st), leaves,
                                         (dy.float(), dst.float())))
    for got, want, what in zip(*grads, "x cs B C".split()):
        assert got.shape == want.shape
        assert _rel(got, want) < 1e-5, what
    # only y used: the state's cotangent is zeros, cs alone wants a grad
    cs1 = cs.float().requires_grad_()
    y, _ = ssd_ops.SsdIntraChunk.apply(x.float(), cs1, *(
        t.float().expand(G, H, Q, N) for t in (Bm, Cm)))
    got, = torch.autograd.grad(y, cs1, dy.float())
    cs2 = cs.float().requires_grad_()
    want, = torch.autograd.grad(ssd_ref.ssd_intra_chunk_ref(
        x.float(), cs2, *(t.float().expand(G, H, Q, N) for t in (Bm, Cm)))[0],
        cs2, dy.float())
    assert _rel(got, want) < 1e-5


def test_ssd_intra_chunk_grads_finite_past_exp_overflow():
    """A chunk whose decay passes exp's f32 range above the diagonal (a
    full-width mamba2 chunk of 256 at dt ~0.7 reaches cs ~ -177): the
    plain version masks before the exp, so the backward stays finite and
    equals the f64 gradient."""
    G, H, Q, P, N = 1, 2, 64, 4, 8
    g = torch.Generator().manual_seed(0)
    x = torch.randn((G, H, Q, P), generator=g)
    cs = -3.0 * torch.arange(Q, dtype=torch.float32).expand(G, H, Q)
    Bm, Cm = (torch.randn((G, H, Q, N), generator=g) for _ in range(2))
    grads = []
    for dt in (torch.float32, torch.float64):
        leaves = [t.to(dt).requires_grad_() for t in (x, cs, Bm, Cm)]
        y, st = ssd_ops.intra_chunk_autograd(*leaves)
        grads.append(torch.autograd.grad(y.sum() + st.sum(), leaves))
    for got, want in zip(*grads):
        assert torch.isfinite(got).all()
        assert _rel(got, want) < 1e-5


# ------------------------------------------------- launcher and example
@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_trains_each_family_on_the_host(arch, capsys, tmp_path):
    tlaunch.main(["--arch", arch, "--steps", "3", "--batch", "2", "--seq",
                  "32", "--device", "cpu", "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "done: 3 steps, restarts=0" in out
    assert (" aux " in out) == (arch != MAMBA2)
    assert checkpoint.available_steps(str(tmp_path)) == [3]


def test_train_lm_example_trains_and_restarts(tmp_path):
    """``repro_torch.examples.train_lm`` on MINI for 10 steps on the CPU in
    its own process, a failure injected at step 5: it recovers from the
    step-4 checkpoint and ends with a checkpoint of step 10."""
    # one host thread: the suite's workers already take every core
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    ckpt = tmp_path / "ckpt"
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.examples.train_lm", "--steps",
         "10", "--batch", "2", "--seq", "32", "--ckpt-every", "4",
         "--inject-failure", "--device", "cpu", "--ckpt-dir", str(ckpt)],
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "restarts=1 resumed_from=4" in out.stdout, out.stdout
    assert max(checkpoint.available_steps(str(ckpt))) == 10
