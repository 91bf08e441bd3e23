"""The port's flash-attention training pair on the CPU: the plain
``flash_attention_fwd_lse_ref`` / ``flash_attention_bwd_ref`` (what the
wrappers run for host tensors) against the JAX Pallas
``flash_attention_fwd_lse`` / ``flash_attention_bwd`` in interpret mode at
``tests/test_flash_bwd.py``'s cases, a GQA case, and the port's ``attend``
under autograd against ``jax.grad`` through ``attend_chunked``'s custom VJP.
Inputs come from numpy seeds."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.flash_attention_bwd import (
    flash_attention_bwd, flash_attention_fwd_lse)
from repro.models import attention as jattn
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention import ref as flash_ref
from repro_torch.models import attention as tattn

PALLAS_ATOL = 2e-3        # tests/test_flash_bwd.py's tolerance
F32_TOL = 1e-5            # f32 both sides: the same formula, other sum order
CASES = [(True, 0, 0.0), (True, 64, 0.0), (False, 0, 0.0), (True, 0, 30.0)]


def _inputs(seed, B, H, Hk, T, dh, dv):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32) for s in
            ((B, H, T, dh), (B, Hk, T, dh), (B, Hk, T, dv), (B, H, T, dv))]


def _pallas(q, k, v, do, kw):
    """The JAX Pallas pair in interpret mode; K/V pre-broadcast over the
    query groups and dk/dv summed back, as the port's GQA contract."""
    H, Hk = q.shape[1], k.shape[1]
    kb, vb = (np.repeat(x, H // Hk, axis=1) for x in (k, v))
    args = [jnp.asarray(x) for x in (q, kb, vb)]
    o, lse = flash_attention_fwd_lse(*args, bq=32, bk=32, interpret=True,
                                     **kw)
    dq, dk, dv = flash_attention_bwd(*args, o, lse, jnp.asarray(do), bq=32,
                                     bk=32, interpret=True, **kw)
    B, T = q.shape[0], q.shape[2]

    def fold(x):
        x = np.asarray(x)
        return x.reshape(B, Hk, H // Hk, T, -1).sum(2)

    return [np.asarray(x) for x in (o, lse, dq)] + [fold(dk), fold(dv)]


@pytest.mark.parametrize("causal,window,softcap", CASES)
@pytest.mark.parametrize("H,Hk,dh,dv", [
    pytest.param(2, 2, 32, 16, id="2-2"), pytest.param(4, 2, 32, 16, id="4-2"),
    # q/k and v head dims at MLA's 3 : 2 ratio (192, 128)
    pytest.param(4, 2, 48, 32, id="4-2-48-32")])
def test_plain_pair_matches_pallas_interpret(causal, window, softcap, H, Hk,
                                             dh, dv):
    q, k, v, do = _inputs(0, 2, H, Hk, 128, dh, dv)
    kw = dict(scale=0.2, causal=causal, window=window, softcap=softcap)
    want = _pallas(q, k, v, do, kw)
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    o, lse = flash_ops.attend_fwd_lse(tq, tk, tv, **kw)
    got = [o, lse, *flash_ops.attend_bwd(tq, tk, tv, o, lse, tdo, **kw)]
    for name, g, w in zip(("o", "lse", "dq", "dk", "dv"), got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), w, atol=PALLAS_ATOL,
                                   err_msg=name)


def test_plain_pair_leaves_the_counters():
    """The plain versions are no kernel launches."""
    q, k, v, do = map(torch.from_numpy, _inputs(1, 1, 2, 1, 16, 8, 8))
    n = (flash_ops.launches, flash_ops.lse_launches, flash_ops.bwd_launches)
    o, lse = flash_ops.attend_fwd_lse(q, k, v, scale=0.3)
    flash_ops.attend_bwd(q, k, v, o, lse, do, scale=0.3)
    assert (flash_ops.launches, flash_ops.lse_launches,
            flash_ops.bwd_launches) == n


def test_lse_of_rows_without_live_keys():
    """Causal + window with Tq > Tk + window - 1: the rows that see no key
    get lse 0 + log(1e-30) and o 0, as ``_attend_fwd`` gives them."""
    rng = np.random.default_rng(2)
    q = torch.from_numpy(rng.normal(size=(1, 2, 40, 8)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(1, 2, 10, 8)).astype(np.float32))
    o, lse = flash_ref.flash_attention_fwd_lse_ref(q, k, k, scale=0.3,
                                                   window=4)
    assert torch.all(o[:, :, 13:] == 0)
    np.testing.assert_allclose(lse[:, :, 13:].numpy(), np.log(1e-30),
                               rtol=1e-6)


@pytest.mark.parametrize("causal,window,softcap", CASES)
def test_attend_autograd_matches_attend_chunked_vjp(causal, window, softcap):
    """The port's ``attend`` (FlashAttention: plain fwd_lse + plain bwd on
    the host) against ``jax.grad`` through ``attend_chunked`` (its XLA
    custom VJP ``_attend_fwd``/``_attend_bwd``), GQA 2 x 3, T = 70 (ragged
    against the 16-chunks), f32."""
    rng = np.random.default_rng(3)
    B, T, Hkv, G, dh = 2, 70, 2, 3, 16
    q = rng.normal(size=(B, T, Hkv, G, dh)).astype(np.float32)
    k = rng.normal(size=(B, T, Hkv, dh)).astype(np.float32)
    v = rng.normal(size=(B, T, Hkv, dh)).astype(np.float32)
    do = rng.normal(size=(B, T, Hkv, G, dh)).astype(np.float32)
    kw = dict(scale=0.25, causal=causal, window=window, softcap=softcap)

    def f(q, k, v):
        out = jattn.attend_chunked(q, k, v, q_chunk=16, kv_chunk=16, **kw)
        return jnp.sum(out * do), out

    (_, jout), jg = jax.value_and_grad(f, argnums=(0, 1, 2), has_aux=True)(
        *map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = tattn.attend(tq, tk, tv, **kw)
    (out * torch.from_numpy(do)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=F32_TOL, atol=F32_TOL)
    for t, w in zip((tq, tk, tv), jg):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w),
                                   rtol=F32_TOL, atol=F32_TOL)


def _graph_names(t):
    names, todo = set(), [t.grad_fn]
    while todo:
        fn = todo.pop()
        if fn is not None and fn.name() not in names:
            names.add(fn.name())
            todo += [f for f, _ in fn.next_functions]
    return names


def test_attend_takes_flash_attention_only_for_gradients():
    """Serving (no input wants a gradient, or grad mode off) runs the
    forward alone; training runs FlashAttention."""
    rng = np.random.default_rng(4)
    q = torch.from_numpy(rng.normal(size=(1, 9, 2, 2, 8)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(1, 9, 2, 8)).astype(np.float32))
    assert tattn.attend(q, k, k, scale=0.3).grad_fn is None
    q.requires_grad_()
    with torch.no_grad():
        assert tattn.attend(q, k, k, scale=0.3).grad_fn is None
    assert "FlashAttentionBackward" in _graph_names(
        tattn.attend(q, k, k, scale=0.3))
