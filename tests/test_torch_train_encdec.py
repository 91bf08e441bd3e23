"""The port's training of the encoder-decoder (whisper-large-v3) and the
front end (internvl2-26b) on the CPU, held against the JAX package at
their smoke configs: the loss and every gradient leaf against
``jax.value_and_grad(loss_fn)`` (whisper through ``encdec_loss``: the
encoder's non-causal attention, the decoder's causal self attention and
the cross attention whose K/V gradients flow back into the encoder;
internvl2 through ``lm_loss`` with ``frontend_embed``, whose gradient
reaches ``frontend_proj``), three whisper train steps against
``jax.jit(make_train_step)`` on a state built by hand,
``synth_batch``'s structure, shapes and mask against JAX's, and the
quickstart example on the host for jamba, whisper and internvl2. The JAX side
runs on a 1×1 mesh with Auto axes, as ``tests/test_torch_train_hybrid.py``.
Parameters come from the JAX initializer, inputs from numpy seeds."""
import dataclasses
import math
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

from repro.configs import all_configs, smoke_config
from repro.models.model import loss_fn as jloss_fn
from repro.models.model import model_defs
from repro.models.model import synth_batch as jsynth_batch
from repro.sharding import params as prm
from repro.sharding.axes import ShardCtx
from repro.train.optimizer import OptConfig as JOpt
from repro.train.optimizer import init_moments as jinit_moments
from repro.train.step import make_train_step as jmake_train_step
from repro_torch import configs as tconfigs
from repro_torch.examples import quickstart
from repro_torch.models import transformer as ttr
from repro_torch.models.model import loss_fn, synth_batch
from repro_torch.params import params_from_numpy, tree_leaves
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.step import make_state, make_train_step
# the JAX oracles compile at XLA's lowest optimization level (most of
# their time is compiling; f32 results agree to rounding)
from test_torch_variants import _jit

WHISPER, VLM, MISTRAL = "whisper-large-v3", "internvl2-26b", \
    "mistral-nemo-12b"
# tests/test_torch_train.py's tolerances: f32 the same formulas in another
# sum order; bf16 both frameworks round every product to bf16, at other
# places
GRAD_TOL = {"float32": 1e-4, "bfloat16": 3e-2}
LOSS_TOL = {"float32": 1e-5, "bfloat16": 1e-3}
SE = 40                  # whisper's stub frames: two attention chunks + 8


@pytest.fixture(scope="module")
def auto_ctx():
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


def _batch(cfg, B=2, S=32, seed=0):
    """``synth_batch``'s structure from numpy: whisper SE frames of
    N(0, 0.1²) and ``max_decoder_len`` decoder tokens; internvl2
    ``frontend_tokens`` embeddings and the mask zero on their positions."""
    rng = np.random.default_rng(seed)
    n = min(cfg.max_decoder_len, 32) if cfg.enc_dec else S
    toks = rng.integers(0, cfg.vocab, (B, n + 1)).astype(np.int32)
    out = {"tokens": toks[:, :-1], "targets": toks[:, 1:],
           "mask": np.ones((B, n), np.float32)}
    if cfg.enc_dec:
        out["frames"] = (rng.standard_normal((B, SE, cfg.d_model))
                         * 0.1).astype(np.float32)
    else:
        ft = cfg.frontend_tokens
        out["frontend_embed"] = (rng.standard_normal(
            (B, ft, cfg.frontend_dim)) * 0.1).astype(np.float32)
        out["mask"][:, :ft] = 0.0
    return out


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


# ---------------------------------------------------- loss and gradients
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", [WHISPER, VLM])
def test_loss_and_grads_match_jax(auto_ctx, arch, dtype):
    """The loss, its metrics and every gradient leaf (whisper: the encoder
    and decoder layers, ``dec_pos``, the tied embedding; internvl2: the
    stack, the embedding and ``frontend_proj``), each within GRAD_TOL of
    its largest value of JAX's; in bf16, where JAX's own bf16 gradient is
    farther than that from the f32 gradient at the same weights, the
    port's no farther from it than JAX's."""
    jcfg, tcfg = _cfgs(arch, dtype)
    ttr.check_trainable(tcfg)
    jp = prm.materialize(model_defs(jcfg), jax.random.PRNGKey(0))
    batch = _batch(jcfg, seed=1)
    (jl, jm), jg = _jgrad(jcfg, jp, batch, auto_ctx)
    tp = make_state(_to_port(jp, tcfg))["params"]
    loss, metrics = loss_fn(tcfg, tp, _torch_batch(batch))
    leaves = tree_leaves(tp)
    grads = torch.autograd.grad(loss, leaves)
    assert set(metrics) == set(jm)
    assert float(metrics["tokens"]) == float(jm["tokens"])
    assert abs(loss.item() - float(jl)) <= LOSS_TOL[dtype] * float(jl)
    want = tree_leaves(_to_port(jg, tcfg))
    assert len(grads) == len(want)
    if arch == VLM:
        proj = tp["embed"]["frontend_proj"]
        assert any(p is proj for p in leaves)
    truth = want
    if dtype == "bfloat16":
        jcfg32, tcfg32 = _cfgs(arch, "float32")
        jp32 = jax.tree.map(lambda x: x.astype(jnp.float32), jp)
        _, jg32 = _jgrad(jcfg32, jp32, batch, auto_ctx)
        truth = tree_leaves(_to_port(jg32, tcfg32))
    for g, w, t, p in zip(grads, want, truth, leaves):
        assert g.dtype == p.dtype and g.shape == p.shape
        assert float(w.abs().max()) > 0
        err = _rel(g, w)
        assert err < GRAD_TOL[dtype] or _rel(g, t) <= _rel(w, t), \
            (tuple(g.shape), err, _rel(g, t), _rel(w, t))


# ------------------------------------------------------------ train step
def test_whisper_train_steps_match_jax(auto_ctx):
    """Three f32 steps (the first at lr 0 of the warmup) against the jitted
    JAX step, with ``test_torch_train.py::test_train_steps_match_jax``'s
    bounds: losses to 1e-4 relative, params to 2.5·lr at most and 1e-6 in
    the median."""
    jcfg, tcfg = _cfgs(WHISPER, "float32")
    kw = dict(lr=1e-3, warmup_steps=1, decay_steps=10)
    jo, to = JOpt(**kw), OptConfig(**kw)
    jp = prm.materialize(model_defs(jcfg), jax.random.PRNGKey(0))
    mom = jinit_moments(jp, jo)
    jstate = {"params": jp, "m": mom["m"], "v": mom["v"],
              "step": jnp.zeros((), jnp.int32)}
    tstate = make_state(_to_port(jp, tcfg), to)
    jstep = _jit(jmake_train_step(jcfg, jo, auto_ctx))
    tstep = make_train_step(tcfg, to)
    batch = _batch(jcfg)
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


# ------------------------------------------------------------ synth_batch
@pytest.mark.parametrize("arch,seq", [(WHISPER, 24), (VLM, 32), (VLM, 10),
                                      (MISTRAL, 16)])
def test_synth_batch_matches_jax_structure(arch, seq):
    """Keys, shapes, dtypes and the mask against JAX's ``synth_batch``:
    whisper frames (B, seq, d) and min(max_decoder_len, 32) decoder tokens;
    internvl2 min(frontend_tokens, seq // 2) embeddings with the mask zero
    there (seq 10 cuts them to 5); a decoder tokens alone. Frames and
    embeddings are N(0, 0.1²), tokens in [0, V), targets the tokens shifted
    by one, and the batch lies on the generator's device and trains."""
    jcfg, tcfg = _cfgs(arch, "float32")
    jb = jsynth_batch(jcfg, 3, seq, jax.random.PRNGKey(0))
    tb = synth_batch(tcfg, 3, seq, torch.Generator().manual_seed(0))
    assert set(tb) == set(jb)
    for k, v in jb.items():
        assert tuple(tb[k].shape) == v.shape, k
        assert tb[k].is_floating_point() == jnp.issubdtype(v.dtype,
                                                           jnp.floating), k
    assert torch.equal(tb["mask"], torch.from_numpy(np.asarray(jb["mask"])))
    assert int(tb["tokens"].min()) >= 0 and \
        int(tb["tokens"].max()) < tcfg.vocab
    assert torch.equal(tb["tokens"][:, 1:], tb["targets"][:, :-1])
    for k in ("frames", "frontend_embed"):
        if k in tb:
            assert tb[k].dtype == torch.float32
            assert 0.07 < float(tb[k].std()) < 0.13, k
    if tcfg.enc_dec:
        assert tb["tokens"].shape[1] == min(tcfg.max_decoder_len, 32)
    elif tcfg.frontend != "none":
        assert tb["frontend_embed"].shape[1] == \
            min(tcfg.frontend_tokens, seq // 2)
    params = make_state(_to_port(
        prm.materialize(model_defs(jcfg), jax.random.PRNGKey(0)),
        tcfg))["params"]
    loss, _ = loss_fn(tcfg, params, tb)
    assert torch.isfinite(loss)


# ------------------------------------------------------------ quickstart
@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", WHISPER, VLM])
def test_quickstart_runs_on_the_host(arch, capsys):
    """``examples/quickstart.py`` ported, in-process with ``--device cpu``:
    one train step of the smoke config on a ``synth_batch`` (the loss near
    ln V of random logits), then prefill and two greedy decode steps; for
    whisper the JAX example's enc-dec message instead."""
    quickstart.main(["--arch", arch, "--device", "cpu"])
    out = capsys.readouterr().out
    assert f"arch={arch}-smoke" in out
    loss = float(re.search(r"train: loss=([\d.]+)", out).group(1))
    assert abs(loss - math.log(512)) < 0.5
    if arch == WHISPER:
        assert "(enc-dec serving demo: see tests/test_serve.py)" in out
        assert "prefill" not in out
    else:
        assert re.search(r"prefill: next token \d+", out)
        assert re.search(r"decode\[1\]: token \d+", out)
