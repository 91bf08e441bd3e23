"""The gathered-view paged decode (``Engine(paged_kernel=False)``: each
slot's whole page table gathered into contiguous rows and attended in
plain torch) and the cache-memory helpers, held against the JAX package on
the CPU in f32.

Streams of mistral-nemo-12b (GQA) and deepseek-v2-236b (MLA + MoE) smoke
through the gathered view equal JAX's engine with the same flag and the
port's kernel path; its verify equals the kernel path's; a flag that is
not a bool raises. ``cache_bytes``, ``page_bytes`` and
``Engine.reserved_cache_bytes`` equal JAX's for every registered config's
smoke size, paged and dense. The JAX side runs on a 1×1 mesh with Auto
axes, as the other MoE and MLA oracles do."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import all_configs, smoke_config
from repro.serve import kv_cache as jkv
from repro.serve.engine import Engine as JEngine
from repro.serve.engine import Request as JRequest
from repro.sharding.axes import ShardCtx
from repro_torch import configs as tconfigs
from repro_torch.params import init_params
from repro_torch.serve import decode as tdec
from repro_torch.serve.engine import Engine, Request
from repro_torch.serve.kv_cache import cache_bytes, page_bytes
from test_torch_spec_decode import _mid_state
from test_torch_jamba import auto_ctx, jax_params  # noqa: F401

PINNED_F = 0.01
LENS = (4, 9, 17, 30)
ENGINE_KW = dict(max_slots=3, max_len=64, page_size=8, decode_quantum=4)
ARCHS = ["mistral-nemo-12b", "deepseek-v2-236b"]


def _cfgs(arch, dtype="float32"):
    return (dataclasses.replace(smoke_config(all_configs()[arch]),
                                param_dtype=dtype),
            dataclasses.replace(tconfigs.smoke_config(
                tconfigs.get_config(arch)), param_dtype=dtype))


def _run(eng, prompts, req=Request):
    eng.tracker.f = lambda: PINNED_F
    reqs = [req(rid=i, prompt=p, max_new=8) for i, p in enumerate(prompts)]
    eng.run(reqs)
    assert all(r.done and len(r.out) == 8 for r in reqs)
    return [r.out for r in reqs]


@pytest.mark.parametrize("arch", ARCHS)
def test_gather_streams_match_jax_and_kernel_path(arch, auto_ctx):
    """Greedy f32 streams of the gathered-view engine equal JAX's engine
    with ``paged_kernel=False`` and the port's paged-kernel engine (on the
    CPU, the kernel's plain version); the gathered engine runs every
    quantum at the full table width (one graph on the card), the kernel
    engine at the live widths."""
    jcfg, tcfg = _cfgs(arch)
    tp = init_params(tcfg, 0, device="cpu")
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, tcfg.vocab, n).tolist() for n in LENS]
    jeng = JEngine(jcfg, jax_params(tcfg, tp), auto_ctx, paged=True,
                   paged_kernel=False, **ENGINE_KW)
    want = _run(jeng, prompts, JRequest)
    gather = Engine(tcfg, tp, device="cpu", paged_kernel=False, **ENGINE_KW)
    assert _run(gather, prompts) == want
    assert set(gather.widths_used) == {gather.pages_per_slot}
    gather.alloc.check()
    assert len(gather.alloc.free) == gather.alloc.usable_pages
    kernel = Engine(tcfg, tp, device="cpu", **ENGINE_KW)
    assert _run(kernel, prompts) == want
    assert kernel.paged_kernel is True


@pytest.mark.parametrize("arch", ARCHS)
def test_gather_verify_equals_kernel_verify(arch):
    """``decode_verify`` and ``decode_step`` through the gathered pages
    equal the kernel path's on a random mid-decode state (K = 4 tokens,
    one slot past several pages, one near the end of its table)."""
    _, tcfg = _cfgs(arch)
    tp = init_params(tcfg, 0, device="cpu")
    cache, pt, pos0, toks = _mid_state(tcfg, True)
    lk, sk = tdec.decode_verify(tcfg, tp, cache, toks, pos0, pt)
    lg, sg = tdec.decode_verify(tcfg, tp, cache, toks, pos0, pt,
                                paged_kernel=False)
    np.testing.assert_allclose(lg.numpy(), lk.numpy(), rtol=1e-5, atol=1e-5)
    for a, b in zip(sk["layers"], sg["layers"]):
        for name in a:
            torch.testing.assert_close(a[name], b[name], rtol=1e-5,
                                       atol=1e-5)
    c2 = {"layers": [{n: t.clone() for n, t in layer.items()}
                     for layer in cache["layers"]]}
    dk, _ = tdec.decode_step(tcfg, tp, cache, toks[:, 0], pos0, pt)
    dg, _ = tdec.decode_step(tcfg, tp, c2, toks[:, 0], pos0, pt,
                             paged_kernel=False)
    np.testing.assert_allclose(dg.numpy(), dk.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("flag", ["interpret", "ref", 1, None])
def test_paged_kernel_must_be_a_bool(flag):
    """JAX also takes the impl strings of its Pallas dispatch ("interpret",
    "ref", ...) and 0/1; the port takes a bool and raises a ValueError for
    anything else."""
    _, tcfg = _cfgs("mistral-nemo-12b")
    tp = init_params(tcfg, 0, device="cpu")
    with pytest.raises(ValueError, match="paged_kernel must be a bool"):
        Engine(tcfg, tp, device="cpu", paged_kernel=flag, **ENGINE_KW)


# ----------------------------------------------------------------- memory
@pytest.mark.parametrize("arch", sorted(all_configs()))
def test_memory_helpers_match_jax(arch):
    """``cache_bytes`` (dense slots × tokens, and whisper's self and cross
    rows) and ``page_bytes`` equal JAX's at one model shard; for a decoder,
    the paged and the dense engine's ``reserved_cache_bytes`` equal JAX's
    engine of the same settings, the sum of the leaves' bytes, and what
    the two helpers give for the layout: the dense cache with each pooled
    layer's slot rows (``max_slots · page_bytes(max_len)``) replaced by
    the pool (``num_pages · page_bytes(page_size)``)."""
    jcfg, tcfg = _cfgs(arch, "bfloat16")
    for batch, seq in ((3, 48), (2, 40)):
        assert cache_bytes(tcfg, batch, seq) == \
            jkv.cache_bytes(jcfg, batch, seq, 1)
    for ps in (8, 16):
        assert page_bytes(tcfg, ps) == jkv.page_bytes(jcfg, ps)
    if tcfg.enc_dec:
        return
    tp = init_params(tcfg, 0, device="cpu")
    slots, max_len, ps = 3, 48, 8
    for paged in (False, True):
        kw = dict(max_slots=slots, max_len=max_len, paged=paged,
                  page_size=ps)
        eng = Engine(tcfg, tp, device="cpu", **kw)
        jeng = JEngine(jcfg, None, ShardCtx(mesh=jax.make_mesh(
            (1, 1), ("data", "model"), devices=jax.devices()[:1])), **kw)
        got = eng.reserved_cache_bytes()
        assert got == jeng.reserved_cache_bytes()
        assert got == sum(t.nbytes for layer in eng.cache["layers"]
                          for t in layer.values())
        want = cache_bytes(tcfg, slots, max_len)
        if paged:
            want += eng.num_pages * page_bytes(tcfg, ps) - \
                slots * page_bytes(tcfg, max_len)
        assert got == want
