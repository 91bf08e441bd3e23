"""The port's sharding layer (``repro_torch/sharding``) against the JAX
package's: the logical-axis law, every parameter leaf's axes, the specs
and counts, a rank's init block, the refusals of ``check_sharded`` and the
engine, and the collectives on one rank. The collectives over gloo ranks
run with the sharded serving cases (``test_torch_sharded_serve.py``),
whose spawned ranks they share."""
import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import all_configs
from repro.models.model import model_defs
from repro.sharding import axes as jaxes
from repro.sharding import params as prm
from repro_torch import configs as tconfigs
from repro_torch.models.transformer import (check_sharded, layer_schedule,
                                            lm_hidden)
from repro_torch.params import ParamSpec, init_params, param_specs, tree_map
from repro_torch.serve import decode as tdec
from repro_torch.serve import engine as teng
from repro_torch.sharding import axes as taxes
from repro_torch.sharding import collectives as coll
from repro_torch.sharding import params as tsp

MESH_SHAPES = [{"data": 1, "model": 1}, {"data": 1, "model": 2},
               {"data": 1, "model": 4}, {"data": 2, "model": 4},
               {"data": 16, "model": 16}, {"pod": 2, "data": 16, "model": 16},
               {"pod": 2, "data": 1, "model": 8}]
AXES = [("embed", "heads", "qk"), ("vocab", "embed"), ("batch", "seq", None),
        ("embed", "kv_heads", "qk"), (None, "kv_seq", "kv_heads", None),
        ("experts", "embed", None), ("batch", "embed"), ("mlp", "embed"),
        ("embed", "embed"), ("heads", "heads"), ("d_inner", "ssm_state"),
        ("batch", "kv_seq", "kv_heads", None)]
SHAPES = [(4096, 32, 128), (8, 8, 8), (6, 12, 2), (32, 2, 16), (128, 16, 4),
          (64, 64, 64, 64), (1, 3, 5, 7)]
WIDE = dict(n_heads=16, n_kv_heads=4, param_dtype="float32")


class _Mesh:
    """What ``repro.sharding.axes.logical_to_spec`` reads of a mesh."""

    def __init__(self, shape):
        self.shape = dict(shape)


def _jax_ctx(shape):
    return jaxes.ShardCtx(mesh=_Mesh(shape))


def _port_ctx(shape, **coords):
    return taxes.ShardCtx(sizes=shape, coords=dict(
        {n: 0 for n in shape}, **coords))


# ------------------------------------------------------------- the law
def test_rule_tables_match_jax():
    assert taxes.DEFAULT_RULES == jaxes.DEFAULT_RULES
    assert taxes.ZERO_POD_RULES == jaxes.ZERO_POD_RULES


@pytest.mark.parametrize("rules", ["default", "zero_pod"])
@pytest.mark.parametrize("mesh", MESH_SHAPES, ids=str)
def test_logical_to_spec_matches_jax(mesh, rules):
    jr = jaxes.DEFAULT_RULES if rules == "default" else jaxes.ZERO_POD_RULES
    tr = taxes.DEFAULT_RULES if rules == "default" else taxes.ZERO_POD_RULES
    for axes, shape in itertools.product(AXES, SHAPES):
        n = min(len(axes), len(shape))
        axes, shape = axes[:n], shape[:n]
        want = tuple(jaxes.logical_to_spec(axes, shape, _Mesh(mesh), jr))
        assert taxes.logical_to_spec(axes, shape, mesh, tr) == want, (
            axes, shape)


def test_mesh_axis_size_and_single_device():
    ctx = taxes.single_device_ctx()
    assert ctx.mesh is None and ctx.axis_size("model") == 1
    assert ctx.axis_index("model") == 0
    assert taxes.model_shard(None) == (1, 0)
    assert taxes.mesh_axis_size(None, ("data", "model")) == 1
    mesh = {"pod": 2, "data": 16, "model": 16}
    assert taxes.mesh_axis_size(mesh, ("pod", "data")) == \
        jaxes.mesh_axis_size(_Mesh(mesh), ("pod", "data")) == 32
    with pytest.raises(ValueError, match="no process group"):
        _port_ctx({"data": 1, "model": 2}).group("model")
    with pytest.raises(ValueError, match="do not lie"):
        taxes.ShardCtx(sizes={"model": 2}, coords={"model": 2})


# --------------------------------------------------------- the leaves
def _jax_unstacked(cfg, fn):
    """JAX's ``model_defs(cfg)`` in the port's tree and layer order, each
    leaf ``fn(axes, shape)`` without its stacked ``layers`` axis."""
    def leaf(d):
        if d.axes and d.axes[0] == "layers":
            return fn(d.axes[1:], d.shape[1:])
        return fn(d.axes, d.shape)

    t = jax.tree.map(leaf, model_defs(cfg), is_leaf=prm.is_def)
    if cfg.enc_dec:
        out = {k: t[k] for k in ("embed", "dec_pos", "enc_norm", "dec_norm",
                                 "unembed")}
        out["enc_layers"] = [t["enc_blocks"]] * cfg.n_enc_layers
        out["dec_layers"] = [t["dec_blocks"]] * cfg.n_layers
        return out
    layers = []
    for seg, seg_tree in zip(layer_schedule(cfg), t["blocks"]):
        layers += [seg_tree[f"s{j}"] for _ in range(seg.repeat)
                   for j in range(len(seg.pattern))]
    return {"embed": t["embed"], "layers": layers,
            "final_norm": t["final_norm"], "unembed": t["unembed"]}


def _is_spec(x):
    return isinstance(x, ParamSpec)


def _tuples(tree):
    out = []
    tree_map(out.append, tree, is_leaf=lambda x: isinstance(x, tuple))
    return out


@pytest.mark.parametrize("arch", sorted(tconfigs.all_configs()))
def test_every_leaf_has_jax_axes(arch):
    jcfg, tcfg = all_configs()[arch], tconfigs.get_config(arch)
    got = tree_map(lambda s: s.axes, param_specs(tcfg), is_leaf=_is_spec)
    assert got == _jax_unstacked(jcfg, lambda axes, shape: tuple(axes))
    # the whole model's counts, and JAX's (its layers stacked)
    defs = model_defs(jcfg)
    assert tsp.n_params(tcfg) == prm.n_params(defs)
    assert tsp.param_bytes(tcfg) == prm.param_bytes(defs)


@pytest.mark.parametrize("arch", ["mistral-nemo-12b", "phi3.5-moe-42b-a6.6b",
                                  "deepseek-v2-236b"])
@pytest.mark.parametrize("mesh", [{"data": 1, "model": 4},
                                  {"data": 2, "model": 8}], ids=str)
def test_specs_and_blocks_match_jax(arch, mesh):
    """Each leaf's spec is JAX's; a rank's block times the parts of each
    dim is the whole leaf."""
    jcfg, tcfg = all_configs()[arch], tconfigs.get_config(arch)
    ctx = _port_ctx(mesh)
    specs = tsp.specs(tcfg, ctx)
    assert specs == _jax_unstacked(jcfg, lambda axes, shape: tuple(
        _jax_ctx(mesh).spec(axes, shape)))
    wholes = tree_map(lambda s: s.shape, param_specs(tcfg), is_leaf=_is_spec)
    for loc, whole, spec in zip(_tuples(tsp.local_shapes(tcfg, ctx)),
                                _tuples(wholes), _tuples(specs)):
        for n, w, e in zip(loc, whole, spec):
            assert n * taxes.mesh_axis_size(mesh, taxes._entry_axes(e)) == w
    n_ranks = int(np.prod(list(mesh.values())))
    assert tsp.param_bytes(tcfg, ctx) * n_ranks >= tsp.param_bytes(tcfg)


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("arch", ["mistral-nemo-12b", "phi3.5-moe-42b-a6.6b"])
def test_rank_init_block_is_slice_of_one_device_init(arch, m):
    cfg = dataclasses.replace(tconfigs.smoke_config(tconfigs.get_config(arch)),
                              **WIDE)
    whole = init_params(cfg, seed=3, device="cpu")
    specs = param_specs(cfg)
    for i in range(m):
        ctx = _port_ctx({"data": 1, "model": m}, model=i)
        mine = init_params(cfg, seed=3, device="cpu", ctx=ctx)
        cut = tsp.shard(whole, cfg, ctx)
        tsp.check_local(mine, cfg, ctx)

        def same(a, b, s, i=i):
            assert torch.equal(a, b), (s, i)
            assert a.shape == ctx.local_shape(s.axes, s.shape)
        tree_map(same, mine, cut, specs)
    # the rank blocks of a sharded leaf tile it: wq's heads, rank-major
    parts = [init_params(cfg, seed=3, device="cpu", ctx=_port_ctx(
        {"data": 1, "model": m}, model=i))["layers"][0]["attn"]["wq"]
        for i in range(m)]
    assert torch.equal(torch.cat(parts, 1), whole["layers"][0]["attn"]["wq"])


# ---------------------------------------------------------- refusals
@pytest.mark.parametrize("arch,match", [
    ("deepseek-v2-236b", "MLA"), ("mamba2-130m", "Mamba"),
    ("jamba-v0.1-52b", "Mamba"), ("whisper-large-v3", "whisper"),
    ("internvl2-26b", "front end"), ("gemma2-2b", "sliding-window"),
    ("h2o-danube-1.8b", "sliding-window")])
def test_check_sharded_refuses_families_that_wait(arch, match):
    cfg = tconfigs.get_config(arch)
    with pytest.raises(ValueError, match=match):
        check_sharded(cfg, _port_ctx({"data": 1, "model": 2}))
    check_sharded(cfg, _port_ctx({"data": 1, "model": 1}))   # one rank


def test_check_sharded_heads_and_widths():
    smoke = tconfigs.smoke_config(tconfigs.get_config("mistral-nemo-12b"))
    check_sharded(smoke, _port_ctx({"data": 1, "model": 2}))
    with pytest.raises(ValueError, match="cp_gqa_attention"):   # 2 KV heads
        check_sharded(smoke, _port_ctx({"data": 1, "model": 4}))
    with pytest.raises(ValueError, match="vocab"):
        check_sharded(dataclasses.replace(smoke, vocab=513),
                      _port_ctx({"data": 1, "model": 2}))
    with pytest.raises(ValueError, match="FFN width"):
        check_sharded(dataclasses.replace(smoke, d_ff=129),
                      _port_ctx({"data": 1, "model": 2}))
    with pytest.raises(ValueError, match="data axis"):
        check_sharded(smoke, _port_ctx({"data": 2, "model": 2}))
    for arch in ("mistral-nemo-12b", "phi3.5-moe-42b-a6.6b"):
        for m in (2, 4, 8):
            check_sharded(tconfigs.get_config(arch),
                          _port_ctx({"data": 1, "model": m}))


def test_engine_refuses_what_a_mesh_cannot_serve():
    cfg = dataclasses.replace(tconfigs.smoke_config(
        tconfigs.get_config("mistral-nemo-12b")), **WIDE)
    ctx = _port_ctx({"data": 1, "model": 4}, model=1)
    params = init_params(cfg, seed=0, device="cpu", ctx=ctx)
    kw = dict(device="cpu", ctx=ctx, max_slots=2, max_len=32)
    for bad, match in ((dict(paged=False), "paged"),
                       (dict(paged_kernel=False), "paged kernel"),
                       (dict(page_size=6, max_len=36), "multiple"),
                       (dict(draft_cfg=cfg, spec_k=2), "speculative")):
        with pytest.raises(ValueError, match=match):
            teng.Engine(cfg, params, **dict(kw, **bad))
    whole = init_params(cfg, seed=0, device="cpu")
    with pytest.raises(ValueError, match="blocks"):
        teng.Engine(cfg, whole, **kw)


# -------------------------------------------------------- collectives
def test_collectives_are_identities_on_one_rank():
    x = torch.arange(12.0).reshape(3, 4)
    for ctx in (taxes.single_device_ctx(),
                _port_ctx({"data": 2, "model": 1})):
        assert coll.all_gather(x, 1, ctx) is x
        assert coll.all_reduce(x, ctx, op="max") is x
        assert coll.broadcast(x, ctx) is x


def test_greedy_picks_the_lowest_index_of_a_tie():
    """The logits' vocab parts are gathered whole before sampling, so a
    greedy tie goes to the lowest index, as ``jnp.argmax`` gives it."""
    rng = np.random.default_rng(0)
    logits = rng.integers(0, 3, size=(6, 512)).astype(np.float32)
    logits[:, [7, 300, 511]] = 5.0                 # ties across vocab parts
    got = tdec._sample_tokens(torch.from_numpy(logits), None,
                              temperature=0.0, top_k=0)
    assert got.tolist() == np.asarray(jnp.argmax(logits, -1)).tolist() \
        == [7] * 6


def test_sharded_stack_refuses_a_gradient():
    """Training across ranks is not ported: the sharded stack runs under
    ``torch.no_grad()`` only (no collective is reached first)."""
    cfg = dataclasses.replace(tconfigs.smoke_config(
        tconfigs.get_config("mistral-nemo-12b")), param_dtype="float32")
    ctx = _port_ctx({"data": 1, "model": 2})
    params = init_params(cfg, seed=0, device="cpu", ctx=ctx)
    with pytest.raises(NotImplementedError, match="no_grad"):
        lm_hidden(cfg, params, torch.zeros((1, 8), dtype=torch.long),
                  ctx=ctx)
