"""The port's Mamba-1 mixer against the JAX package on the CPU: the
selective scan's plain version (``kernels/selective_scan/ref.py``) against
JAX's chunked scan (``repro/models/mamba.py::mamba1_mixer``'s
``chunk_body`` under ``lax.scan``, carried from a given state) and a
float64 recurrence, ``mamba1_mixer`` with its state and ``mamba1_step``
against JAX's in f32 and bf16, and tests/test_mamba.py's version-1 cases
(full pass against steps, a prefill state continued by steps, padding as a
no-op). Parameters come from the JAX initializer, inputs from numpy
seeds."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JModelConfig
from repro.configs.base import SSMCfg as JSSMCfg
from repro.models import mamba as jm
from repro.sharding import params as prm
from repro_torch.configs.base import ModelConfig, SSMCfg
from repro_torch.kernels.selective_scan import ops as scan_ops
from repro_torch.kernels.selective_scan import ref as scan_ref
from repro_torch.models import mamba as tm
from repro_torch.params import ParamSpec, _from_numpy, tree_map

CHUNK = 16
SCAN_TOL = 1e-5          # f32: one recurrence, another order of its sums
MIXER_TOL = 5e-3         # tests/test_mamba.py full-vs-step / continuation
F32_TOL = 1e-4           # the mixer in f32 against JAX's
BF16_TOL = 3e-2          # tests/test_kernels.py for bf16


def _cfgs(dtype="float32"):
    """tests/test_mamba.py::_cfg(1) in both packages."""
    kw = dict(name="m1", family="ssm", n_layers=2, d_model=32, n_heads=0,
              n_kv_heads=0, head_dim=0, d_ff=0, vocab=64, use_rope=False,
              param_dtype=dtype)
    ssm = dict(d_state=8, d_conv=4, expand=2, head_dim=8, version=1,
               chunk=CHUNK)
    return (JModelConfig(ssm=JSSMCfg(**ssm), **kw),
            ModelConfig(ssm=SSMCfg(**ssm), **kw))


def _params(jcfg):
    jp = prm.materialize(jm.mamba1_defs(jcfg), jax.random.PRNGKey(0))
    return jp, tree_map(lambda a: _from_numpy(a, "cpu"),
                        jax.tree.map(np.asarray, jp))


def _rel(got, want) -> float:
    got = np.asarray(torch.as_tensor(got).detach().float().numpy(),
                     np.float64)
    want = np.asarray(np.asarray(want, np.float32), np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# ------------------------------------------------------------------ scan
def _jax_scan(x, dt, A, Bm, Cm, h0, chunk):
    """JAX's selective scan as ``mamba1_mixer`` computes it
    (repro/models/mamba.py:278-313), carried from ``h0``."""
    B, S, C = x.shape
    N = A.shape[1]
    Q = min(chunk, S)
    pad = (-S) % Q
    if pad:
        x, dt, Bm, Cm = (jnp.pad(t, ((0, 0), (0, pad), (0, 0)))
                         for t in (x, dt, Bm, Cm))
    nc = (S + pad) // Q
    xf, dtc = x.reshape(B, nc, Q, C), dt.reshape(B, nc, Q, C)
    Bc, Cc = Bm.reshape(B, nc, Q, N), Cm.reshape(B, nc, Q, N)

    def chunk_body(h, inp):
        xq, dq, bq, cq = inp
        da = jnp.exp(dq[..., None] * A)
        u = (dq * xq)[..., None] * bq[:, :, None, :]
        u = u.at[:, 0].add(da[:, 0] * h)
        _, h_all = jax.lax.associative_scan(
            lambda l, r: (l[0] * r[0], r[0] * l[1] + r[1]), (da, u), axis=1)
        return h_all[:, -1], jnp.einsum("bqcn,bqn->bqc", h_all, cq)

    h_last, ys = jax.lax.scan(
        chunk_body, h0, tuple(jnp.moveaxis(t, 1, 0)
                              for t in (xf, dtc, Bc, Cc)))
    return jnp.moveaxis(ys, 0, 1).reshape(B, S + pad, C)[:, :S], h_last


def _naive_scan(x, dt, A, Bm, Cm, h0):
    """The recurrence step by step in float64."""
    x, dt, A, Bm, Cm, h = (np.asarray(t, np.float64)
                           for t in (x, dt, A, Bm, Cm, h0))
    ys = []
    for t in range(x.shape[1]):
        h = np.exp(dt[:, t, :, None] * A) * h + \
            (dt[:, t] * x[:, t])[..., None] * Bm[:, t, None, :]
        ys.append(np.einsum("bcn,bn->bc", h, Cm[:, t]))
    return np.stack(ys, 1), h


def _scan_inputs(S, h0_nonzero, B=2, C=12, N=8, seed=0):
    rng = np.random.default_rng(seed + S)
    x = rng.normal(size=(B, S, C)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(size=(B, S, C)) - 1)).astype(np.float32)
    A = -np.exp(rng.normal(size=(C, N)) * 0.5).astype(np.float32)
    Bm = rng.normal(size=(B, S, N)).astype(np.float32)
    Cm = rng.normal(size=(B, S, N)).astype(np.float32)
    h0 = (rng.normal(size=(B, C, N)) if h0_nonzero
          else np.zeros((B, C, N))).astype(np.float32)
    return x, dt, A, Bm, Cm, h0


@pytest.mark.parametrize("h0_nonzero", [False, True], ids=["h0=0", "h0"])
@pytest.mark.parametrize("S", [1, CHUNK - 1, CHUNK, 3 * CHUNK + 5])
def test_scan_plain_matches_jax_scan(S, h0_nonzero):
    """S of one step, short of a chunk, one chunk, and a ragged tail."""
    ins = _scan_inputs(S, h0_nonzero)
    y, h = scan_ops.selective_scan(*map(torch.from_numpy, ins), CHUNK)
    assert y.shape == (2, S, 12) and h.shape == (2, 12, 8)
    assert y.dtype == h.dtype == torch.float32
    jy, jh = _jax_scan(*map(jnp.asarray, ins), CHUNK)
    ny, nh = _naive_scan(*ins)
    assert _rel(y, jy) <= SCAN_TOL and _rel(h, jh) <= SCAN_TOL
    assert _rel(y, ny) <= SCAN_TOL and _rel(h, nh) <= SCAN_TOL


def test_scan_plain_padding_is_noop():
    """A tail padded to a whole chunk (zero x and dt) changes nothing: a
    non-multiple S at chunk 16 equals S as one chunk."""
    ins = [torch.from_numpy(a) for a in _scan_inputs(37, True, seed=3)]
    y16, h16 = scan_ref.selective_scan_ref(*ins, 16)
    y37, h37 = scan_ref.selective_scan_ref(*ins, 37)
    assert _rel(y16, y37.numpy()) <= SCAN_TOL
    assert _rel(h16, h37.numpy()) <= SCAN_TOL


def test_scan_wrapper_checks_what_the_kernel_takes():
    """The wrapper's checks of the kernel's operands (the card path), and
    a device that is neither the card nor the CPU refused."""
    x, dt, A, Bm, Cm, h0 = map(torch.from_numpy, _scan_inputs(5, True,
                                                              N=16))
    scan_ops._check(x, dt, A, Bm, Cm, h0)
    with pytest.raises(ValueError, match="multiple of 8"):
        scan_ops._check(x, dt, *(t[..., :12].contiguous()
                                 for t in (A, Bm, Cm, h0)))
    with pytest.raises(ValueError, match="contiguous"):
        scan_ops._check(x.transpose(0, 1).contiguous().transpose(0, 1), dt,
                        A, Bm, Cm, h0)
    with pytest.raises(ValueError, match="float32"):
        scan_ops._check(x.double(), dt, A, Bm, Cm, h0)
    with pytest.raises(ValueError, match="wants"):
        scan_ops._check(x, dt, A, Bm[:, :4], Cm, h0)
    with pytest.raises(ValueError, match="cuda or cpu"):
        scan_ops.selective_scan(*(t.to("meta") for t in
                                  (x, dt, A, Bm, Cm, h0)), 16)


# ----------------------------------------------------------------- mixer
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mixer_state_and_step_match_jax(dtype, ctx):
    """``mamba1_mixer`` (output and decode state) over 32 tokens (two
    chunks), then five ``mamba1_step``s from that state, against JAX's on
    the same inputs."""
    jcfg, tcfg = _cfgs(dtype)
    jp, tp = _params(jcfg)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    x = (np.random.default_rng(5).normal(size=(2, 37, 32)) * 0.5).astype(
        np.float32)
    jx = jnp.asarray(x, jcfg.pdtype)
    tx = torch.from_numpy(x).to(tcfg.pdtype)
    out, state = tm.mamba1_mixer(tcfg, tp, tx[:, :32], return_state=True)
    jout, jstate = jm.mamba1_mixer(jcfg, jp, jx[:, :32], ctx,
                                   return_state=True)
    assert set(state) == set(jstate) == {"conv_x", "ssm"}
    assert state["ssm"].dtype == torch.float32
    assert state["conv_x"].dtype == tcfg.pdtype
    assert _rel(out, jout) <= tol
    for name in ("conv_x", "ssm"):
        assert _rel(state[name], jstate[name]) <= tol, name
    for t in range(32, 37):
        out, state = tm.mamba1_step(tcfg, tp, tx[:, t], state)
        jout, jstate = jm.mamba1_step(jcfg, jp, jx[:, t], jstate, ctx)
        assert _rel(out, jout) <= tol, t
    assert _rel(state["ssm"], jstate["ssm"]) <= tol


def test_mixer_state_past_a_ragged_chunk(ctx):
    """At S = 40 (chunk 16: a padded tail) the output and the SSM state
    match JAX's, and the conv state is the last d_conv - 1 pre-conv inputs
    of the prompt. JAX's conv state is not: ``mamba1_mixer`` slices it
    after S grew by the padding (repro/models/mamba.py:320), which at S =
    40 leaves it empty."""
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg)
    x = (np.random.default_rng(9).normal(size=(2, 40, 32)) * 0.5).astype(
        np.float32)
    out, state = tm.mamba1_mixer(tcfg, tp, torch.from_numpy(x),
                                 return_state=True)
    jout, jstate = jm.mamba1_mixer(jcfg, jp, jnp.asarray(x), ctx,
                                   return_state=True)
    assert _rel(out, jout) <= F32_TOL
    assert _rel(state["ssm"], jstate["ssm"]) <= F32_TOL
    assert jstate["conv_x"].shape[1] == 0
    K = tcfg.ssm.d_conv - 1
    assert torch.equal(state["conv_x"],
                       torch.from_numpy(x[:, -K:]) @ tp["wx"])


def test_full_vs_step_decode():
    """tests/test_mamba.py::test_full_vs_step_decode[1]: the full pass
    equals 48 steps from the zero state."""
    jcfg, tcfg = _cfgs()
    _, tp = _params(jcfg)
    x = torch.from_numpy((np.random.default_rng(6).normal(
        size=(2, 48, 32)) * 0.5).astype(np.float32))
    y_full = tm.mamba1_mixer(tcfg, tp, x)
    state = tree_map(lambda s: torch.zeros(s.shape, dtype=s.dtype),
                     tm.mamba_state_defs(tcfg, 2),
                     is_leaf=lambda n: isinstance(n, ParamSpec))
    outs = []
    for t in range(48):
        o, state = tm.mamba_step(tcfg, tp, x[:, t], state)
        outs.append(o)
    np.testing.assert_allclose(y_full.numpy(), torch.stack(outs, 1).numpy(),
                               atol=MIXER_TOL)


def test_prefill_state_continues_exactly():
    """tests/test_mamba.py::test_prefill_state_continues_exactly[1]: the
    state of the mixer at S = 32, continued by steps, ≡ the mixer over
    40."""
    jcfg, tcfg = _cfgs()
    _, tp = _params(jcfg)
    x = torch.from_numpy((np.random.default_rng(7).normal(
        size=(2, 40, 32)) * 0.5).astype(np.float32))
    _, state = tm.mamba_mixer(tcfg, tp, x[:, :32], return_state=True)
    outs = []
    for t in range(32, 40):
        o, state = tm.mamba1_step(tcfg, tp, x[:, t], state)
        outs.append(o)
    y_full = tm.mamba1_mixer(tcfg, tp, x)[:, 32:]
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), y_full.numpy(),
                               atol=MIXER_TOL)


@pytest.mark.parametrize("S", [1, 2])
def test_prompt_shorter_than_the_conv_continues_exactly(S):
    """A prompt shorter than d_conv - 1: the conv state holds zeros before
    the prompt, as the causal conv does, so steps continue the mixer."""
    jcfg, tcfg = _cfgs()
    _, tp = _params(jcfg)
    x = torch.from_numpy((np.random.default_rng(S).normal(
        size=(2, 6, 32)) * 0.5).astype(np.float32))
    _, state = tm.mamba1_mixer(tcfg, tp, x[:, :S], return_state=True)
    assert state["conv_x"].shape == (2, tcfg.ssm.d_conv - 1, tcfg.d_inner)
    outs = []
    for t in range(S, 6):
        o, state = tm.mamba1_step(tcfg, tp, x[:, t], state)
        outs.append(o)
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(),
                               tm.mamba1_mixer(tcfg, tp, x)[:, S:].numpy(),
                               atol=SCAN_TOL)


def test_mixer_padding_is_noop(ctx):
    """tests/test_mamba.py::test_padding_is_noop for Mamba-1: S = 37 at
    chunk 16 equals chunk 37, in the port and in JAX."""
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg)
    x = (np.random.default_rng(8).normal(size=(1, 37, 32)) * 0.5).astype(
        np.float32)
    one = dataclasses.replace(tcfg, ssm=dataclasses.replace(tcfg.ssm,
                                                            chunk=37))
    y16 = tm.mamba1_mixer(tcfg, tp, torch.from_numpy(x))
    y37 = tm.mamba1_mixer(one, tp, torch.from_numpy(x))
    np.testing.assert_allclose(y16.numpy(), y37.numpy(), atol=SCAN_TOL)
    jy = jm.mamba1_mixer(jcfg, jp, jnp.asarray(x), ctx)
    assert _rel(y16, jy) <= F32_TOL


def test_state_defs_and_dispatch():
    """The Mamba-1 decode state: the conv tail in the parameter dtype, the
    SSM state (batch, C, N) in f32, as JAX's ``mamba1_state_defs``; the
    dispatchers pick the version's functions."""
    jcfg, tcfg = _cfgs("bfloat16")
    defs = tm.mamba_state_defs(tcfg, 3)
    jdefs = jm.mamba1_state_defs(jcfg, 3)
    assert {k: v.shape for k, v in defs.items()} == \
        {k: tuple(v.shape) for k, v in jdefs.items()}
    assert defs["conv_x"].dtype == torch.bfloat16
    assert defs["ssm"].dtype == torch.float32
    two = dataclasses.replace(tcfg, ssm=dataclasses.replace(tcfg.ssm,
                                                            version=2))
    assert set(tm.mamba_state_defs(two, 3)) == {"conv_x", "conv_B",
                                                "conv_C", "ssm"}
