"""The port's training of Mamba-1 and the hybrid stack on the CPU, held
against the JAX package: jamba-v0.1-52b smoke (8 layers: Mamba-1 mixers,
attention at slot 4, MoE of 8 experts top-2 on the odd slots, dense SwiGLU
FFNs on the even ones) — the loss, ``moe_aux`` and every gradient leaf
against ``jax.value_and_grad(loss_fn)``, and three train steps against
``jax.jit(make_train_step)`` on a state built by hand — and the selective
scan's backward: ``selective_scan_bwd_ref`` (the reverse recurrence over
the states saved every ``TILE`` steps, the CPU path of ``SelectiveScan``)
against autograd through ``selective_scan_ref``. The JAX side runs on a
1×1 mesh with Auto axes: on the default Explicit-axis mesh jamba's
gradient raises a ``ShardingTypeError`` (the MoE class of
``tests/test_torch_train_families.py::auto_ctx``). Parameters come from
the JAX initializer, inputs from numpy seeds."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax.sharding import AxisType

from repro.configs import all_configs, smoke_config
from repro.models.model import loss_fn as jloss_fn
from repro.models.model import model_defs
from repro.models.transformer import lm_hidden as jlm_hidden
from repro.sharding import params as prm
from repro.sharding.axes import ShardCtx
from repro.train.optimizer import OptConfig as JOpt
from repro.train.optimizer import init_moments as jinit_moments
from repro.train.step import make_train_step as jmake_train_step
from repro_torch import configs as tconfigs
from repro_torch.kernels.selective_scan import ops as scan_ops
from repro_torch.kernels.selective_scan import ref as scan_ref
from repro_torch.models.model import loss_fn
from repro_torch.models.transformer import lm_hidden
from repro_torch.params import params_from_numpy, tree_leaves
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.step import make_state, make_train_step
# the JAX oracles compile at XLA's lowest optimization level (most of
# their time is compiling; f32 results agree to rounding)
from test_torch_variants import _jit

ARCH = "jamba-v0.1-52b"
# tests/test_torch_train.py's tolerances: f32 the same formulas in another
# sum order; bf16 both frameworks round every product to bf16, at other
# places
GRAD_TOL = {"float32": 1e-4, "bfloat16": 3e-2}
LOSS_TOL = {"float32": 1e-5, "bfloat16": 1e-3}
# a batch on which both packages route every MoE slot alike in both dtypes
# (the test asserts it first; bf16 routes apart at seeds 0, 1 and 3)
BATCH_SEED = 2


@pytest.fixture(scope="module")
def auto_ctx():
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         devices=jax.devices()[:1],
                         axis_types=(AxisType.Auto, AxisType.Auto))
    return ShardCtx(mesh=mesh)


def _cfgs(dtype):
    j = dataclasses.replace(smoke_config(all_configs()[ARCH]),
                            param_dtype=dtype)
    t = dataclasses.replace(tconfigs.smoke_config(tconfigs.get_config(ARCH)),
                            param_dtype=dtype)
    return j, t


def _batch(vocab, B=2, S=40, seed=0):
    """S 40: a whole chunk of 32 and a ragged tail, over two scan tiles."""
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
    a, b = a.detach().double(), b.detach().double()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def _jgrad(jcfg, jp, batch, ctx):
    return _jit(jax.value_and_grad(
        lambda p, b: jloss_fn(jcfg, p, b, ctx), has_aux=True))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})


# ------------------------------------------------------ the scan backward
def _scan_inputs(B, S, C, N, dtype, seed=0):
    rng = np.random.default_rng(seed)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape)).to(dtype)
    x = t(B, S, C)
    dt = F.softplus(t(B, S, C) - 1.0)
    A = -torch.exp(0.5 * t(C, N))
    return [x, dt, A, t(B, S, N), t(B, S, N), t(B, C, N)], t(B, S, C), \
        t(B, C, N)


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-10),
                                       (torch.float32, 1e-4)])
@pytest.mark.parametrize("S,chunk,tile", [
    pytest.param(77, 32, 32, id="77-32"), pytest.param(100, 48, 32,
                                                       id="100-48"),
    pytest.param(5, 32, 32, id="5-32"),
    # the kernels' checkpoint interval: S short of one, just past one and
    # several off the boundary
    pytest.param(77, 32, scan_ref.TILE, id="77-32-kernel-tile"),
    pytest.param(100, 48, scan_ref.TILE, id="100-48-kernel-tile"),
    pytest.param(5, 32, scan_ref.TILE, id="5-32-kernel-tile"),
    pytest.param(17, 32, scan_ref.TILE, id="17-32-kernel-tile")])
def test_scan_bwd_ref_matches_autograd(S, chunk, tile, dtype, tol):
    """dx, ddt, dA, dB, dC and dh0 from the reverse recurrence over the
    saved tile states against autograd through the chunked log-step
    forward, with a nonzero h0 and dh_last, at S not a multiple of the tile
    (32, or the kernels' ``TILE``) or the chunk; each within ``tol`` of its
    largest value (f64: the two orders of the same sums; f32: their
    round-off over ~100 steps)."""
    ins, dy, dh = _scan_inputs(2, S, 24, 16, dtype)
    leaves = [t.clone().requires_grad_() for t in ins]
    y, h = scan_ref.selective_scan_ref(*leaves, chunk)
    want = torch.autograd.grad((y, h), leaves, (dy, dh))
    y2, h2, hs = scan_ref.selective_scan_ref(*ins, chunk, tile=tile)
    assert torch.equal(y2, y.detach()) and torch.equal(h2, h.detach())
    assert hs.shape == (2, -(-S // tile), 24, 16) and hs.dtype == dtype
    got = scan_ref.selective_scan_bwd_ref(*ins[:5], hs, dy, dh, tile=tile)
    for name, g, w in zip(("dx", "ddt", "dA", "dB", "dC", "dh0"), got, want):
        assert g.shape == w.shape and g.dtype == dtype, name
        assert _rel(g, w) < tol, (name, _rel(g, w))


def _tile_states_are_the_recurrence(tile: int, chunk: int = 48):
    ins, _, _ = _scan_inputs(2, 70, 16, 8, torch.float64, seed=3)
    x, dt, A, Bm, Cm, h = ins
    _, _, hs = scan_ref.selective_scan_ref(*ins, chunk, tile=tile)
    assert hs.shape[1] == -(-70 // tile)
    for t in range(70):
        if t % tile == 0:
            assert torch.allclose(hs[:, t // tile], h, rtol=0,
                                  atol=1e-12), t
        h = torch.exp(dt[:, t, :, None] * A) * h + \
            (dt[:, t] * x[:, t])[..., None] * Bm[:, t, None, :]


def test_scan_tile_states_are_the_recurrence():
    """The saved states are the state entering each tile of 32 steps (h0
    first), as the step-by-step recurrence gives them (f64)."""
    _tile_states_are_the_recurrence(32)


@pytest.mark.parametrize("tile,chunk", [(scan_ref.TILE, 48),
                                        (scan_ref.TILE, 7), (64, 48)])
def test_scan_tile_states_are_the_recurrence_at(tile, chunk):
    """The same at the kernels' checkpoint interval (``TILE``, one a
    kernel tile), with chunks of JAX's scan that do not line up with it,
    and at 64."""
    _tile_states_are_the_recurrence(tile, chunk)


def test_selective_scan_trains_through_its_autograd_function():
    """With an input that wants a gradient the public scan runs
    :class:`SelectiveScan` (its backward the plain reverse recurrence on the
    CPU) and matches autograd through the plain forward; without one it
    runs the forward alone and saves nothing."""
    ins, dy, dh = _scan_inputs(2, 45, 32, 16, torch.float32, seed=1)
    leaves = [t.clone().requires_grad_() for t in ins]
    y, h = scan_ops.selective_scan(*leaves, 32)
    assert type(y.grad_fn).__name__ == "SelectiveScanBackward"
    got = torch.autograd.grad((y, h), leaves, (dy, dh))
    leaves = [t.clone().requires_grad_() for t in ins]
    want = torch.autograd.grad(scan_ref.selective_scan_ref(*leaves, 32),
                               leaves, (dy, dh))
    for g, w in zip(got, want):
        assert _rel(g, w) < 1e-4
    with torch.no_grad():
        out = scan_ops.selective_scan(*leaves, 32)
    assert len(out) == 2 and out[0].grad_fn is None
    assert torch.equal(out[0], y.detach())


# ---------------------------------------------------- loss and gradients
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_jamba_loss_and_grads_match_jax(auto_ctx, dtype):
    """Every leaf of jamba smoke — the Mamba-1 mixers' projections, conv,
    A_log, D and dt bias, the attention layer, the experts, router and
    dense FFNs — and ``moe_aux``. Routing is discontinuous, so the batch is
    one where both packages route every slot alike, and the test first
    holds that: the slot counts of the MoE layers are equal (their
    fractions, multiples of 1/(T·k), summed over four layers round apart
    by an ulp).
    Each gradient leaf within GRAD_TOL of its largest value of JAX's; in
    bf16, where JAX's own bf16 gradient is farther than that from the f32
    gradient at the same weights, the port's no farther from it than
    JAX's."""
    jcfg, tcfg = _cfgs(dtype)
    jp = prm.materialize(model_defs(jcfg), jax.random.PRNGKey(0))
    batch = _batch(jcfg.vocab, seed=BATCH_SEED)
    (jl, jm), jg = _jgrad(jcfg, jp, batch, auto_ctx)
    tp = make_state(_to_port(jp, tcfg))["params"]
    jstats = _jit(lambda p, t: jlm_hidden(jcfg, p, t, auto_ctx)[1])(
        jp, jnp.asarray(batch["tokens"]))
    with torch.no_grad():
        _, stats = lm_hidden(tcfg, tp, _torch_batch(batch)["tokens"])
    slots = batch["tokens"].size * jcfg.moe.top_k
    assert torch.equal(torch.round(stats[1] * slots), torch.round(
        torch.tensor(np.asarray(jstats[1])) * slots))
    loss, metrics = loss_fn(tcfg, tp, _torch_batch(batch))
    grads = torch.autograd.grad(loss, tree_leaves(tp))
    assert set(metrics) == set(jm) and "moe_aux" in jm
    assert abs(loss.item() - float(jl)) <= LOSS_TOL[dtype] * float(jl)
    assert float(jm["moe_aux"]) > 0
    assert abs(float(metrics["moe_aux"]) - float(jm["moe_aux"])) <= \
        LOSS_TOL[dtype] * float(jm["moe_aux"])
    want = tree_leaves(_to_port(jg, tcfg))
    assert len(grads) == len(want)
    truth = want
    if dtype == "bfloat16":
        jcfg32, tcfg32 = _cfgs("float32")
        jp32 = jax.tree.map(lambda x: x.astype(jnp.float32), jp)
        _, jg32 = _jgrad(jcfg32, jp32, batch, auto_ctx)
        truth = tree_leaves(_to_port(jg32, tcfg32))
    for g, w, t, p in zip(grads, want, truth, tree_leaves(tp)):
        assert g.dtype == p.dtype and g.shape == p.shape
        err = _rel(g, w)
        assert err < GRAD_TOL[dtype] or _rel(g, t) <= _rel(w, t), \
            (tuple(g.shape), err, _rel(g, t), _rel(w, t))


# ------------------------------------------------------------ train step
def test_jamba_train_steps_match_jax(auto_ctx):
    """Three f32 steps (the first at lr 0 of the warmup) against the jitted
    JAX step, with ``test_torch_train.py::test_train_steps_match_jax``'s
    bounds: losses to 1e-4 relative, params to 2.5·lr at most (a near-zero
    gradient can flip the sign of Adam's first update) and 1e-6 in the
    median."""
    jcfg, tcfg = _cfgs("float32")
    kw = dict(lr=1e-3, warmup_steps=1, decay_steps=10)
    jo, to = JOpt(**kw), OptConfig(**kw)
    jp = prm.materialize(model_defs(jcfg), jax.random.PRNGKey(0))
    mom = jinit_moments(jp, jo)
    jstate = {"params": jp, "m": mom["m"], "v": mom["v"],
              "step": jnp.zeros((), jnp.int32)}
    tstate = make_state(_to_port(jp, tcfg), to)
    jstep = _jit(jmake_train_step(jcfg, jo, auto_ctx))
    tstep = make_train_step(tcfg, to)
    batch = _batch(jcfg.vocab, seed=BATCH_SEED)
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
