"""The port's kernel modules on the CPU: the plain versions that the wrappers
run for host tensors, held against the JAX references and the Pallas
kernels in interpret mode (as tests/test_paged_kernel.py and
tests/test_kernels.py run them). Inputs come from numpy seeds."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.flash_attention import flash_attention
from repro.kernels.flash_attention.ref import flash_attention_ref
from repro.kernels.paged_attention import ref as jax_paged_ref
from repro.kernels.paged_attention.paged_attention import \
    paged_flash_decode_gqa
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.paged_attention import ops as paged_ops

F32_TOL = 1e-5
BF16_TOL = 3e-2          # as tests/test_kernels.py


def _gqa_case(page_size, seed=0, hkv=2, grp=3, dh=16, B=3, T=4):
    """Random pools + disjoint-page table + multi-page positions (the
    tests/test_paged_kernel.py cases, as numpy arrays)."""
    rng = np.random.default_rng(seed)
    N = 1 + B * T
    q = rng.normal(size=(B, hkv, grp, dh)).astype(np.float32)
    pk = rng.normal(size=(N, page_size, hkv, dh)).astype(np.float32)
    pv = rng.normal(size=(N, page_size, hkv, dh)).astype(np.float32)
    pt = (1 + rng.permutation(N - 1)[:B * T].reshape(B, T)).astype(np.int32)
    pos = np.asarray([page_size - 1, 2 * page_size, T * page_size - 1][:B],
                     np.int32)
    return q, pk, pv, pt, pos


@pytest.mark.parametrize("page_size", [8, 16])
@pytest.mark.parametrize("softcap", [0.0, 5.0])
@pytest.mark.parametrize("base_frac", [0, 2])
def test_paged_plain_matches_jax(page_size, softcap, base_frac):
    case = _gqa_case(page_size)
    base = page_size // base_frac if base_frac else 0
    kw = dict(page_size=page_size, scale=0.25, softcap=softcap)
    got = paged_ops.paged_attend_gqa(*map(torch.from_numpy, case), base,
                                     **kw)
    jcase = [jnp.asarray(a) for a in case]
    want_ref = jax_paged_ref.paged_flash_decode_gqa_ref(*jcase, base, **kw)
    want_kernel = paged_flash_decode_gqa(*jcase, base, interpret=True, **kw)
    for g, wr, wk in zip(got, want_ref, want_kernel):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(wr), rtol=F32_TOL,
                                   atol=F32_TOL)
        np.testing.assert_allclose(g.numpy(), np.asarray(wk), rtol=F32_TOL,
                                   atol=F32_TOL)


@pytest.mark.parametrize("shard", [0, 1])
def test_paged_plain_shard_local_pool(shard):
    """A pool holding one model shard's half of every page: in-page dim
    ps_loc = page_size / 2, offset 0 at global position base = shard·ps_loc
    (the JAX kernel's sharded contract)."""
    q, pk, pv, pt, pos = _gqa_case(16)
    ps_loc = 8
    pk, pv = pk[:, shard * ps_loc:(shard + 1) * ps_loc], \
        pv[:, shard * ps_loc:(shard + 1) * ps_loc]
    case = (q, np.ascontiguousarray(pk), np.ascontiguousarray(pv), pt, pos)
    kw = dict(page_size=16, scale=0.25, softcap=0.0)
    got = paged_ops.paged_attend_gqa(*map(torch.from_numpy, case),
                                     shard * ps_loc, **kw)
    want = paged_flash_decode_gqa(*map(jnp.asarray, case), shard * ps_loc,
                                  interpret=True, **kw)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=F32_TOL,
                                   atol=F32_TOL)


def test_paged_plain_leaves_counter():
    """The plain version is no kernel launch."""
    n0 = paged_ops.launches
    paged_ops.paged_attend_gqa(*map(torch.from_numpy, _gqa_case(8)),
                               page_size=8, scale=0.25)
    assert paged_ops.launches == n0


def _qkv(seed, B, H, Hk, T, dh, dv):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, H, T, dh)).astype(np.float32),
            rng.normal(size=(B, Hk, T, dh)).astype(np.float32),
            rng.normal(size=(B, Hk, T, dv)).astype(np.float32))


def _torch(a, dtype):
    return torch.from_numpy(a).to(dtype)


def _jax(a, dtype):
    return jnp.asarray(a).astype(jnp.bfloat16 if dtype == torch.bfloat16
                                 else jnp.float32)


@pytest.mark.parametrize("causal,window,softcap", [
    (True, 0, 0.0), (True, 64, 0.0), (False, 0, 0.0), (True, 0, 30.0),
    (True, 32, 50.0),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_plain_matches_jax(causal, window, softcap, dtype):
    q, k, v = _qkv(0, 2, 3, 3, 128, 32, 16)
    kw = dict(scale=0.18, causal=causal, window=window, softcap=softcap)
    got = flash_ops.attend(*(_torch(a, dtype) for a in (q, k, v)), **kw)
    jq, jk, jv = (_jax(a, dtype) for a in (q, k, v))
    tol = BF16_TOL if dtype == torch.bfloat16 else F32_TOL
    got = got.float().numpy()
    np.testing.assert_allclose(
        got, np.asarray(flash_attention_ref(jq, jk, jv, **kw), np.float32),
        rtol=tol, atol=tol)
    if dtype == torch.float32:      # one Pallas interpret run per mask
        np.testing.assert_allclose(
            got, np.asarray(flash_attention(jq, jk, jv, bq=32, bk=32,
                                            interpret=True, **kw)),
            rtol=tol, atol=tol)


def test_flash_plain_gqa_matches_broadcast_jax():
    """k/v with Hkv < H heads against the JAX call on the pre-broadcast
    heads (query head h reads kv head h // G)."""
    q, k, v = _qkv(1, 2, 6, 2, 64, 16, 16)
    kw = dict(scale=0.25, causal=True, window=0, softcap=0.0)
    got = flash_ops.attend(*map(torch.from_numpy, (q, k, v)), **kw)
    jk, jv = (jnp.repeat(jnp.asarray(a), 3, axis=1) for a in (k, v))
    want = flash_attention(jnp.asarray(q), jk, jv, bq=32, bk=32,
                           interpret=True, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=F32_TOL,
                               atol=F32_TOL)


@pytest.mark.parametrize("window", [0, 48])
def test_flash_plain_dh80_matches_pallas_interpret(window):
    """h2o-danube-1.8b's head dim (dh = dv = 80, 4 query heads over 1 here,
    causal, with and without a window shorter than T) against the Pallas
    kernel in interpret mode on the pre-broadcast heads."""
    q, k, v = _qkv(3, 1, 4, 1, 128, 80, 80)
    kw = dict(scale=80 ** -0.5, causal=True, window=window, softcap=0.0)
    got = flash_ops.attend(*map(torch.from_numpy, (q, k, v)), **kw)
    jk, jv = (jnp.repeat(jnp.asarray(a), 4, axis=1) for a in (k, v))
    want = flash_attention(jnp.asarray(q), jk, jv, bq=32, bk=32,
                           interpret=True, **kw)
    assert got.shape == (1, 4, 128, 80)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=F32_TOL,
                               atol=F32_TOL)


@pytest.mark.parametrize("T", [37, 100])
def test_flash_plain_ragged_matches_jax_ref(T):
    """A length that no 512/32 block divides (the card kernel masks it)."""
    q, k, v = _qkv(2, 1, 2, 2, T, 16, 16)
    kw = dict(scale=0.25, causal=True, window=16, softcap=0.0)
    got = flash_ops.attend(*map(torch.from_numpy, (q, k, v)), **kw)
    want = flash_attention_ref(*map(jnp.asarray, (q, k, v)), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=F32_TOL,
                               atol=F32_TOL)


def test_wrappers_refuse_other_devices():
    """Only host tensors take the plain version; the rest launch or raise."""
    meta = torch.empty((1, 2, 4, 8), device="meta")
    with pytest.raises(ValueError):
        flash_ops.attend(meta, meta, meta, scale=0.1)
    pool = torch.empty((2, 4, 2, 8), device="meta")
    idx = torch.zeros((1, 1), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        paged_ops.paged_attend_gqa(meta.reshape(1, 2, 4, 8)[:, :, :1], pool,
                                   pool, idx, idx[:, 0], page_size=4,
                                   scale=0.1)
