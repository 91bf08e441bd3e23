"""The port's training slice on the CPU, held against the JAX package on
the mistral-nemo-12b smoke config: the loss and every gradient leaf
against ``jax.value_and_grad(loss_fn)``, three train steps against
``jax.jit(make_train_step)`` on a state built by hand from
``materialize`` (``train/step.py::init_state`` is red in the reference:
its sharded params break the jitted step), and mirrors of the JAX
package's optimizer, compression, checkpoint, loop, loader and loss tests
on the port alone. Parameters come from the JAX initializer, tokens from
numpy seeds."""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import all_configs, smoke_config
from repro.models.model import loss_fn as jloss_fn
from repro.models.model import model_defs
from repro.sharding import params as prm
from repro.train.compression import CompressionConfig as JCompression
from repro.train.compression import init_residuals as jinit_residuals
from repro.train.optimizer import OptConfig as JOpt
from repro.train.optimizer import init_moments as jinit_moments
from repro.train.step import make_train_step as jmake_train_step
from repro_torch import configs as tconfigs
from repro_torch.data.loader import PrefetchLoader
from repro_torch.data.synthetic import SyntheticLM
from repro_torch.launch import train as tlaunch
from repro_torch.models import layers as tl
from repro_torch.models import transformer as ttr
from repro_torch.models.model import loss_fn, synth_batch
from repro_torch.params import (init_params, params_from_numpy, tree_leaves,
                                tree_map)
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.compression import (CompressionConfig,
                                           compress_decompress,
                                           init_residuals, wire_bytes)
from repro_torch.train.elastic import FailureInjector
from repro_torch.train.loop import LoopConfig, train_loop
from repro_torch.train.optimizer import (OptConfig, adamw_update,
                                         clip_by_global_norm, init_moments,
                                         schedule)
from repro_torch.train.step import init_state, make_state, make_train_step
# the JAX oracles compile at XLA's lowest optimization level (most of
# their time is compiling; f32 results agree to rounding)
from test_torch_variants import _jit

ARCH = "mistral-nemo-12b"
# f32: the same formulas in another sum order. bf16: both frameworks round
# every product to bf16, at other places (measured 1.0e-2 of the largest
# gradient); 3e-2 is tests/test_kernels.py's bf16 tolerance
GRAD_TOL = {"float32": 1e-4, "bfloat16": 3e-2}
LOSS_TOL = {"float32": 1e-5, "bfloat16": 1e-3}


def _cfgs(dtype, **extra):
    j = dataclasses.replace(smoke_config(all_configs()[ARCH]),
                            param_dtype=dtype, **extra)
    t = dataclasses.replace(tconfigs.smoke_config(tconfigs.get_config(ARCH)),
                            param_dtype=dtype, **extra)
    return j, t


def _batch(vocab, B=4, S=32, seed=0):
    toks = np.random.default_rng(seed).integers(0, vocab, (B, S + 1))
    toks = toks.astype(np.int32)
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:],
            "mask": np.ones((B, S), np.float32)}


def _jax_params(jcfg):
    return prm.materialize(model_defs(jcfg), jax.random.PRNGKey(0))


def _to_port(tree, tcfg):
    return params_from_numpy(jax.tree.map(np.asarray, tree), tcfg,
                             device="cpu")


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


# ---------------------------------------------------- loss and gradients
@pytest.mark.parametrize("dtype,extra", [
    ("float32", {}), ("float32", dict(sliding_window=16, attn_softcap=20.0)),
    ("bfloat16", {})], ids=["f32", "f32-window-softcap", "bf16"])
def test_loss_and_grads_match_jax(ctx, dtype, extra):
    jcfg, tcfg = _cfgs(dtype, **extra)
    jp = _jax_params(jcfg)
    batch = _batch(jcfg.vocab)
    (jl, _), jg = _jit(jax.value_and_grad(
        lambda p, b: jloss_fn(jcfg, p, b, ctx), has_aux=True))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    tp = make_state(_to_port(jp, tcfg))["params"]
    loss, metrics = loss_fn(tcfg, tp, _torch_batch(batch))
    grads = torch.autograd.grad(loss, tree_leaves(tp))
    assert float(metrics["tokens"]) == 4 * 32
    assert abs(loss.item() - float(jl)) <= LOSS_TOL[dtype] * float(jl)
    for g, w, p in zip(grads, tree_leaves(_to_port(jg, tcfg)),
                       tree_leaves(tp)):
        assert g.dtype == p.dtype
        err = float((g.float() - w.float()).abs().max() /
                    w.float().abs().max())
        assert err < GRAD_TOL[dtype], (tuple(g.shape), err)


# ------------------------------------------------------------ train step
@pytest.mark.parametrize("mb,moments,compression", [
    (1, "float32", "none"), (2, "float32", "none"), (1, "int8", "none"),
    (1, "float32", "int8")])
def test_train_steps_match_jax(ctx, mb, moments, compression):
    """Three steps (the first at lr 0 of the warmup) against the jitted JAX
    step, f32. A near-zero gradient can flip the sign of Adam's first
    update, so params are held to 2.5·lr at most and 1e-6 in the median;
    the losses to 1e-4 relative."""
    jcfg, tcfg = _cfgs("float32")
    kw = dict(lr=1e-3, warmup_steps=1, decay_steps=10, moments_dtype=moments)
    jo, to = JOpt(**kw), OptConfig(**kw)
    jp = _jax_params(jcfg)
    mom = jinit_moments(jp, jo)
    jstate = {"params": jp, "m": mom["m"], "v": mom["v"],
              "step": jnp.zeros((), jnp.int32)}
    if compression != "none":
        jstate["ef"] = jinit_residuals(jp)
    tstate = make_state(_to_port(jp, tcfg), to,
                        CompressionConfig(compression))
    jstep = _jit(jmake_train_step(jcfg, jo, ctx,
                                     JCompression(compression),
                                     microbatches=mb))
    tstep = make_train_step(tcfg, to, CompressionConfig(compression),
                            microbatches=mb)
    batch = _batch(jcfg.vocab)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    for _ in range(3):
        jstate, jm = jstep(jstate, jb)
        tstate, tm = tstep(tstate, _torch_batch(batch))
        assert abs(float(tm["loss"]) - float(jm["loss"])) <= \
            1e-4 * float(jm["loss"])
    assert tstate["step"] == 3
    diff = torch.cat([(a.detach() - b).abs().reshape(-1) for a, b in zip(
        tree_leaves(tstate["params"]),
        tree_leaves(_to_port(jstate["params"], tcfg)))])
    assert float(diff.max()) <= 2.5 * to.lr
    assert float(diff.median()) < 1e-6


def test_training_reduces_loss():
    """15 steps on one batch (bf16 params, f32 and int8 moments) lower the
    loss by more than 0.5, as tests/test_train.py on the reference."""
    _, tcfg = _cfgs("bfloat16")
    batch = synth_batch(tcfg, 4, 64, torch.Generator().manual_seed(1))
    for moments in ("float32", "int8"):
        ocfg = OptConfig(lr=3e-3, warmup_steps=5, decay_steps=200,
                         moments_dtype=moments)
        state = init_state(tcfg, 0, ocfg=ocfg, device="cpu")
        step = make_train_step(tcfg, ocfg)
        losses = []
        for _ in range(15):
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
        assert losses[-1] < losses[0] - 0.5, (moments, losses)


def test_microbatches_accumulate_the_same_update():
    """mb = 1 and mb = 4 give (nearly) the same update, f32."""
    _, tcfg = _cfgs("float32")
    batch = synth_batch(tcfg, 4, 32, torch.Generator().manual_seed(1))
    ocfg = OptConfig(lr=1e-3, warmup_steps=0)
    outs = []
    for mb in (1, 4):
        state = init_state(tcfg, 0, ocfg=ocfg, device="cpu")
        state, _ = make_train_step(tcfg, ocfg, microbatches=mb)(state, batch)
        outs.append(state["params"])
    err = max(float((a - b).detach().abs().max()) for a, b in zip(
        tree_leaves(outs[0]), tree_leaves(outs[1])))
    assert err < 1e-4


def test_check_trainable_refuses_what_is_not_ported():
    """The port trains every family it lays out (GQA, MLA, MoE gated or not
    with shared experts and dense first layers, Mamba-2, Mamba-1, hybrids,
    enc-dec and front ends, each accepted by ``check_trainable`` and
    ``make_train_step``), sliding-window MLA among them, which serving
    refuses, naming the JAX reference's fault (held against JAX in
    ``tests/test_torch_variants.py``). Refused, each with its own message:
    an SSM version other than 1 and 2, and an activation not ported."""
    _, tcfg = _cfgs("float32")
    ttr.check_trainable(dataclasses.replace(tcfg, sliding_window=16))
    for arch in ("deepseek-v2-236b", "phi3.5-moe-42b-a6.6b", "mamba2-130m",
                 "jamba-v0.1-52b", "whisper-large-v3", "internvl2-26b"):
        cfg = tconfigs.smoke_config(tconfigs.get_config(arch))
        ttr.check_trainable(cfg)
        make_train_step(cfg, OptConfig())
    ssm = tconfigs.smoke_config(tconfigs.get_config("mamba2-130m"))
    mla = tconfigs.smoke_config(tconfigs.get_config("deepseek-v2-236b"))
    moe = tconfigs.smoke_config(tconfigs.get_config("phi3.5-moe-42b-a6.6b"))
    windowed = dataclasses.replace(mla, sliding_window=16)
    for cfg in (dataclasses.replace(ssm, ssm=dataclasses.replace(
                    ssm.ssm, version=1)),
                dataclasses.replace(ssm, family="hybrid", d_ff=128,
                                    ssm=dataclasses.replace(
                                        ssm.ssm, attn_period=2)),
                dataclasses.replace(tcfg, frontend="vision",
                                    frontend_tokens=4, frontend_dim=32),
                windowed, dataclasses.replace(moe, act="relu2")):
        ttr.check_trainable(cfg)
        make_train_step(cfg, OptConfig())
    with pytest.raises(NotImplementedError, match="trained but not served"):
        ttr.check_supported(windowed)
    for cfg, msg in (
            (dataclasses.replace(ssm, ssm=dataclasses.replace(
                ssm.ssm, version=3)), "SSM version 3"),
            (dataclasses.replace(moe, act="silu"), "activation 'silu'")):
        with pytest.raises(NotImplementedError, match=msg):
            ttr.check_trainable(cfg)
        with pytest.raises(NotImplementedError, match=msg):
            make_train_step(cfg, OptConfig())


# ------------------------------------------------------- optimizer pieces
def test_adamw_matches_reference():
    ocfg = OptConfig(lr=1e-2, warmup_steps=0, decay_steps=10 ** 9,
                     min_lr_ratio=1.0, weight_decay=0.1)
    rng = np.random.default_rng(0)
    w = rng.normal(size=(8, 16)).astype(np.float32)
    g = (rng.normal(size=(8, 16)) * 0.1).astype(np.float32)
    p = {"w": torch.from_numpy(w.copy())}
    mom = init_moments(p, ocfg)
    new_p, _, _, lr = adamw_update(p, {"w": torch.from_numpy(g)}, mom["m"],
                                   mom["v"], 0, ocfg)
    m2, v2 = (1 - ocfg.b1) * g, (1 - ocfg.b2) * g ** 2
    upd = (m2 / (1 - ocfg.b1)) / (np.sqrt(v2 / (1 - ocfg.b2)) + ocfg.eps)
    want = w - lr * (upd + ocfg.weight_decay * w)
    np.testing.assert_allclose(new_p["w"].numpy(), want, rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("moments", ["float32", "int8"])
def test_adamw_rows_at_a_time_equal_one_pass(monkeypatch, moments):
    """The update in passes of a few rows (``UPDATE_CHUNK``) gives the
    params and moments of one pass over each leaf, bit for bit: the update
    is elementwise and the int8 scales are per row."""
    from repro_torch.train import optimizer
    ocfg = OptConfig(lr=1e-2, warmup_steps=0, moments_dtype=moments)
    g = torch.Generator().manual_seed(0)
    shapes = {"w": (6, 5, 160), "b": (37,), "e": (7, 700)}
    outs = []
    for chunk in (1 << 26, 700):
        monkeypatch.setattr(optimizer, "UPDATE_CHUNK", chunk)
        g.manual_seed(0)
        p = {k: torch.randn(s, generator=g) for k, s in shapes.items()}
        mom = init_moments(p, ocfg)
        for step in range(3):
            grads = {k: torch.randn(s, generator=g) for k, s in shapes.items()}
            p, m, v, _ = adamw_update(p, grads, mom["m"], mom["v"], step,
                                      ocfg)
            mom = {"m": m, "v": v}
        outs.append(tree_leaves((p, mom)))
    assert optimizer.is_quantized(mom["m"]["e"]) == (moments == "int8")
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def test_schedule_warmup_cosine():
    ocfg = OptConfig(lr=1.0, warmup_steps=10, decay_steps=110,
                     min_lr_ratio=0.1)
    assert schedule(ocfg, 0) == 0.0
    assert abs(schedule(ocfg, 10) - 1.0) < 1e-6
    assert abs(schedule(ocfg, 110) - 0.1) < 1e-6


def test_clip_by_global_norm():
    g = {"a": torch.full((4,), 10.0)}
    clipped, gn = clip_by_global_norm(g, 1.0)
    assert abs(float(gn) - 20.0) < 1e-4
    assert abs(float(torch.linalg.norm(clipped["a"])) - 1.0) < 1e-4


def test_compression_error_feedback():
    g = {"w": torch.from_numpy(np.random.default_rng(0).normal(
        size=(64, 64)).astype(np.float32))}
    for kind, tol in (("int8", 0.05), ("topk", 0.25)):
        ccfg = CompressionConfig(kind=kind, topk_frac=0.1)
        res = init_residuals(g)
        acc = torch.zeros_like(g["w"])
        err_at = {}
        for i in range(20):
            dec, res = compress_decompress(g, res, ccfg)
            acc = acc + dec["w"]
            if i in (0, 19):
                err_at[i] = float((acc / (i + 1) - g["w"]).abs().mean())
        assert err_at[19] < tol, (kind, err_at)
        assert err_at[19] < err_at[0]
        assert wire_bytes(g, ccfg) < wire_bytes(g, CompressionConfig())
    big = {"w": torch.zeros((1024, 1024))}
    assert wire_bytes(big, CompressionConfig("int8")) < \
        wire_bytes(big, CompressionConfig()) / 3.9


# ------------------------------------------------------------ the loss
def test_chunked_ce_equals_direct():
    _, tcfg = _cfgs("bfloat16")
    params = init_params(tcfg, seed=0, device="cpu")
    g = torch.Generator().manual_seed(1)
    B, S = 2, 48
    h = torch.randn((B, S, tcfg.d_model), generator=g).to(tcfg.pdtype)
    targets = torch.randint(0, tcfg.vocab, (B, S), generator=g)
    mask = (torch.rand((B, S), generator=g) > 0.2).float()
    sl, sc = tl.chunked_ce_loss(tcfg, params["embed"], params["unembed"], h,
                                targets, mask, chunk=16)
    logits = tl.logits_fn(tcfg, params["embed"], params["unembed"], h)
    lab = logits.gather(-1, targets[..., None])[..., 0]
    direct = torch.sum((torch.logsumexp(logits, -1) - lab) * mask)
    np.testing.assert_allclose(float(sl), float(direct), rtol=1e-4)
    assert float(sc) == float(mask.sum())


# ------------------------------------------------------------ data
def test_prefetch_loader_order():
    data = SyntheticLM(31, 16, seed=3)
    src = [data.batch(2) for _ in range(5)]
    loader = PrefetchLoader(iter(src), device="cpu", prefetch=2)
    got = list(loader)
    loader.close()
    assert len(got) == 5
    for a, b in zip(src, got):
        np.testing.assert_array_equal(a["tokens"], b["tokens"].numpy())


def test_prefetch_loader_hands_on_a_source_error_and_closes():
    def source():
        yield SyntheticLM(31, 16, seed=3).batch(2)
        raise OSError("disk gone")

    loader = PrefetchLoader(source(), device="cpu")
    next(loader)
    with pytest.raises(OSError, match="disk gone"):
        next(loader)
    endless = PrefetchLoader(SyntheticLM(31, 16).iterator(2), device="cpu",
                             prefetch=1)
    next(endless)
    endless.close()
    assert not endless._thread.is_alive()


# ------------------------------------------------------------ checkpoints
def _state():
    g = torch.Generator().manual_seed(0)
    return {"params": {"w": torch.randn((8, 4), generator=g),
                       "h": torch.randn((3, 5), generator=g).bfloat16(),
                       "b": torch.zeros((4,))},
            "m": {"w": {"q": torch.ones((8, 4), dtype=torch.int8),
                        "s": torch.full((8, 1), 0.5)}},
            "step": 7}


def test_checkpoint_roundtrip(tmp_path):
    state = _state()
    ckpt.save(str(tmp_path), state, 7)
    restored, step = ckpt.restore(str(tmp_path), state)
    assert step == 7 and restored["step"] == 7
    for a, b in zip(tree_leaves(restored), tree_leaves(state)):
        if isinstance(b, torch.Tensor):
            assert a.dtype == b.dtype
            assert torch.equal(a, b)


def test_checkpoint_latest_valid_wins(tmp_path):
    state = _state()
    ckpt.save(str(tmp_path), state, 5)
    state2 = tree_map(lambda x: x + 1, state)
    ckpt.save(str(tmp_path), state2, 10)
    restored, step = ckpt.restore(str(tmp_path), state)
    assert step == 10
    assert torch.equal(restored["params"]["b"], state2["params"]["b"])


def test_checkpoint_corruption_falls_back(tmp_path):
    state = _state()
    ckpt.save(str(tmp_path), state, 5)
    ckpt.save(str(tmp_path), state, 10)
    d = os.path.join(tmp_path, "step_10")
    victim = sorted(f for f in os.listdir(d) if f.endswith(".npy"))[0]
    with open(os.path.join(d, victim), "r+b") as f:
        f.seek(10)
        f.write(b"\xde\xad\xbe\xef")
    _, step = ckpt.restore(str(tmp_path), state)
    assert step == 5


def test_checkpoint_async_save(tmp_path):
    saver = ckpt.AsyncSaver()
    try:
        saver.save(str(tmp_path), _state(), 3).result(timeout=60)
    finally:
        saver.close()
    assert ckpt.available_steps(str(tmp_path)) == [3]


def test_loop_restarts_from_checkpoint(tmp_path):
    _, tcfg = _cfgs("bfloat16")
    ocfg = OptConfig(lr=1e-3, warmup_steps=2, decay_steps=40)
    lcfg = LoopConfig(ckpt_dir=str(tmp_path), total_steps=12, ckpt_every=4,
                      async_ckpt=False, max_restarts=2)
    data = SyntheticLM(tcfg.vocab, 32, seed=0)
    inj = FailureInjector({6: RuntimeError("simulated node failure")})
    loader = PrefetchLoader(data.iterator(2), device="cpu")
    try:
        res = train_loop(tcfg, ocfg, lcfg, loader, failure_injector=inj,
                         device="cpu")
    finally:
        loader.close()
    assert res.restarts == 1 and inj.fired == [6]
    assert res.state["step"] == 12
    assert "simulated node failure" in res.failures[0]
    steps = [r["step"] for r in res.history]
    assert steps.count(5) == 2 and steps.count(6) == 2   # re-ran from 4


def test_loop_gives_up_after_max_restarts(tmp_path):
    _, tcfg = _cfgs("bfloat16")
    lcfg = LoopConfig(ckpt_dir=str(tmp_path), total_steps=8, ckpt_every=100,
                      async_ckpt=False, max_restarts=1)
    data = SyntheticLM(tcfg.vocab, 32, seed=0)

    class AlwaysFail(FailureInjector):
        def maybe_fail(self, step):
            if step == 2:
                raise RuntimeError("persistent failure")

    with pytest.raises(RuntimeError, match="persistent"):
        train_loop(tcfg, OptConfig(), lcfg,
                   (_torch_batch(b) for b in data.iterator(2)),
                   failure_injector=AlwaysFail({}), device="cpu")


def test_launcher_trains_on_the_host(capsys, tmp_path):
    tlaunch.main(["--arch", ARCH, "--steps", "3", "--batch", "2", "--seq",
                  "32", "--device", "cpu", "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "done: 3 steps, restarts=0" in out
    assert ckpt.available_steps(str(tmp_path)) == [3]
