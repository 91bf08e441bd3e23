"""Config, parameter bridge, block schedule and layer functions of the port
against their JAX counterparts on the mistral-nemo-12b smoke config (CPU).
Inputs come from numpy seeds; parameters from the JAX initializer."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import all_configs, smoke_config
from repro.models import attention as jattn
from repro.models import layers as jl
from repro.models.model import model_defs
from repro.models.transformer import block_cfg_for_layer, layer_schedule
from repro.sharding import params as prm
from repro_torch import configs as tconfigs
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tl
from repro_torch.models import transformer as ttr
from repro_torch.params import (init_params, n_params, param_specs,
                                params_from_numpy, tree_leaves, tree_map)

ARCH = "mistral-nemo-12b"
ATOL = 1e-5


def _cfgs(dtype="float32"):
    j = dataclasses.replace(smoke_config(all_configs()[ARCH]),
                            param_dtype=dtype)
    t = dataclasses.replace(tconfigs.smoke_config(tconfigs.get_config(ARCH)),
                            param_dtype=dtype)
    return j, t


@pytest.fixture(scope="module")
def jcfg_tcfg():
    return _cfgs()


@pytest.fixture(scope="module")
def trees(jcfg_tcfg):
    jcfg, tcfg = jcfg_tcfg
    jp = prm.materialize(model_defs(jcfg), jax.random.PRNGKey(0))
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), tcfg,
                                 device="cpu")


@pytest.mark.parametrize("smoke", [False, True])
def test_config_fields_match_jax(smoke):
    j = all_configs()[ARCH]
    t = tconfigs.get_config(ARCH)
    if smoke:
        j, t = smoke_config(j), tconfigs.smoke_config(t)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.pdtype == torch.bfloat16


def test_block_schedule_matches_jax(jcfg_tcfg):
    jcfg, tcfg = jcfg_tcfg
    full_j, full_t = all_configs()[ARCH], tconfigs.get_config(ARCH)
    for jc, tc in ((jcfg, tcfg), (full_j, full_t)):
        assert [dataclasses.asdict(b) for b in ttr.block_cfgs(tc)] == \
            [dataclasses.asdict(block_cfg_for_layer(jc, i))
             for i in range(jc.n_layers)]
        assert [(len(s.pattern), s.repeat) for s in ttr.layer_schedule(tc)] \
            == [(len(s.pattern), s.repeat) for s in layer_schedule(jc)]


def test_param_count_matches_jax():
    assert n_params(tconfigs.get_config(ARCH)) == \
        prm.n_params(model_defs(all_configs()[ARCH]))


def test_params_from_numpy_unstacks_in_layer_order(jcfg_tcfg, trees):
    jcfg, _ = jcfg_tcfg
    jp, tp = trees
    assert len(tp["layers"]) == jcfg.n_layers
    stacked = jp["blocks"][0]["s0"]
    for i, layer in enumerate(tp["layers"]):
        np.testing.assert_array_equal(layer["attn"]["wq"].numpy(),
                                      np.asarray(stacked["attn"]["wq"][i]))
        np.testing.assert_array_equal(layer["mlp"]["w_down"].numpy(),
                                      np.asarray(stacked["mlp"]["w_down"][i]))
    np.testing.assert_array_equal(tp["unembed"]["w"].numpy(),
                                  np.asarray(jp["unembed"]["w"]))


def test_params_from_numpy_bf16_bits():
    jcfg, tcfg = _cfgs("bfloat16")
    jp = prm.materialize(model_defs(jcfg), jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    t = tp["embed"]["table"]
    assert t.dtype == torch.bfloat16
    assert tp["final_norm"].dtype == torch.float32
    np.testing.assert_array_equal(
        t.view(torch.int16).numpy(),
        np.asarray(jp["embed"]["table"]).view(np.int16))


def test_params_from_numpy_rejects_wrong_tree(jcfg_tcfg, trees):
    _, tcfg = jcfg_tcfg
    jp, _ = trees
    bad = dataclasses.replace(tcfg, d_ff=2 * tcfg.d_ff)
    with pytest.raises(ValueError):
        params_from_numpy(jax.tree.map(np.asarray, jp), bad, device="cpu")


def test_init_params_shapes_scales_and_seed(jcfg_tcfg):
    _, tcfg = jcfg_tcfg
    a = init_params(tcfg, seed=0, device="cpu")
    b = init_params(tcfg, seed=0, device="cpu")
    c = init_params(tcfg, seed=1, device="cpu")
    shapes = tree_map(lambda s: (s.shape, s.dtype), param_specs(tcfg))
    assert tree_map(lambda t: (tuple(t.shape), t.dtype), a) == shapes
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(a),
                                                 tree_leaves(b)))
    assert not torch.equal(a["embed"]["table"], c["embed"]["table"])
    assert torch.all(a["final_norm"] == 1)
    out_scale = 0.02 / (2 * tcfg.n_layers) ** 0.5
    assert abs(float(a["embed"]["table"].std()) - 0.02) < 2e-3
    assert abs(float(a["layers"][0]["mlp"]["w_down"].std()) - out_scale) < \
        out_scale * 0.1


# ---------------------------------------------------------------- layers
def _x(shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), rtol=atol,
                               atol=atol)


def test_rmsnorm():
    x, w = _x((2, 5, 64)), _x((64,), 1)
    _close(tl.rmsnorm(torch.from_numpy(x), torch.from_numpy(w), 1e-5),
           jl.rmsnorm(jnp.asarray(x), jnp.asarray(w), 1e-5))


@pytest.mark.parametrize("batched", [False, True])
def test_rope(batched):
    pos = np.array([[0, 3, 17, 63], [5, 6, 7, 4095]], np.int32)
    if not batched:
        pos = pos[0]
    x = _x((2, 4, 3, 16))
    cos, sin = tl.rope_tables(torch.from_numpy(pos), 16, 1e6)
    jcos, jsin = jl.rope_tables(jnp.asarray(pos), 16, 1e6)
    _close(cos, jcos)
    _close(sin, jsin)
    _close(tl.apply_rope(torch.from_numpy(x), cos, sin),
           jl.apply_rope(jnp.asarray(x), jcos, jsin))


@pytest.mark.parametrize("act", ["swiglu", "geglu"])
def test_gate_fn(act):
    x = _x((3, 40))
    _close(tl.gate_fn(act)(torch.from_numpy(x)),
           jl.gate_fn(act)(jnp.asarray(x)))


def test_mlp_embed_logits_softcap(jcfg_tcfg, trees):
    jcfg, tcfg = jcfg_tcfg
    jp, tp = trees
    x = _x((2, 5, tcfg.d_model))
    jmlp = jax.tree.map(lambda a: a[0], jp["blocks"][0]["s0"]["mlp"])
    _close(tl.mlp(tcfg, tp["layers"][0]["mlp"], torch.from_numpy(x)),
           jl.mlp(jcfg, jmlp, jnp.asarray(x), _ctx()))
    toks = np.array([[1, 7, 511], [0, 3, 3]], np.int32)
    _close(tl.embed(tcfg, tp["embed"], torch.from_numpy(toks)),
           jl.embed(jcfg, jp["embed"], jnp.asarray(toks), _ctx()))
    lg = tl.logits_fn(tcfg, tp["embed"], tp["unembed"], torch.from_numpy(x))
    assert lg.dtype == torch.float32
    _close(lg, jl.logits_fn(jcfg, jp["embed"], jp["unembed"],
                            jnp.asarray(x), _ctx()))
    _close(tl._softcap(torch.from_numpy(x), 5.0),
           jl._softcap(jnp.asarray(x), 5.0))


def test_logits_bf16_operands_f32_out():
    """bf16 operands give f32 logits of exact products on the host."""
    jcfg, tcfg = _cfgs("bfloat16")
    jp = prm.materialize(model_defs(jcfg), jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    h = _x((1, 3, tcfg.d_model))
    th = torch.from_numpy(h).to(torch.bfloat16)
    lg = tl.logits_fn(tcfg, tp["embed"], tp["unembed"], th)
    assert lg.dtype == torch.float32
    _close(lg, jl.logits_fn(jcfg, jp["embed"], jp["unembed"],
                            jnp.asarray(h).astype(jnp.bfloat16), _ctx()),
           atol=1e-4)


def test_gqa_project(jcfg_tcfg, trees):
    jcfg, tcfg = jcfg_tcfg
    jp, tp = trees
    x = _x((2, 7, tcfg.d_model))
    pos = np.arange(7, dtype=np.int32)
    jattn_p = jax.tree.map(lambda a: a[0], jp["blocks"][0]["s0"]["attn"])
    got = tattn.gqa_project(tcfg, tp["layers"][0]["attn"],
                            torch.from_numpy(x), torch.from_numpy(pos))
    want = jattn.gqa_project(jcfg, jattn_p, jnp.asarray(x), _ctx(),
                             jnp.asarray(pos))
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        _close(g, w)


def test_attend_matches_attend_chunked():
    """The port's prefill attention (flash op, plain version on the host)
    against the XLA ``attend_chunked`` it replaces: causal GQA + softcap."""
    rng = np.random.default_rng(5)
    q = rng.normal(size=(2, 21, 2, 2, 16)).astype(np.float32)
    k = rng.normal(size=(2, 21, 2, 16)).astype(np.float32)
    v = rng.normal(size=(2, 21, 2, 16)).astype(np.float32)
    for window, softcap in ((0, 0.0), (8, 20.0)):
        kw = dict(scale=0.25, causal=True, window=window, softcap=softcap)
        got = tattn.attend(*map(torch.from_numpy, (q, k, v)), **kw)
        want = jattn.attend_chunked(*map(jnp.asarray, (q, k, v)), q_chunk=8,
                                    kv_chunk=8, **kw)
        _close(got, want)


def _ctx():
    from repro.sharding.axes import single_device_ctx
    return single_device_ctx()
