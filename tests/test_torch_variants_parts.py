"""Two parts of the variants of ``tests/test_torch_variants.py`` held
against the JAX package on the CPU in f32, apart from the served stacks:
the MoE block and its decode with a non-gated FFN (two grouped GEMMs
around the activation, with and without a shared expert), and windowed
MLA, which the port trains and does not serve (its loss and gradients
against ``jax.value_and_grad``, and the reference's fault that keeps it
from being served). The JAX side runs on the 1×1 Auto-axis mesh, as in
``tests/test_torch_variants.py``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import MoECfg as JMoECfg
from repro.configs.base import ModelConfig as JModelConfig
from repro.models import moe as jmoe
from repro.serve import prefill as jpre
from repro.sharding import params as prm
from repro_torch.configs.base import MoECfg, ModelConfig
from repro_torch.kernels.grouped_gemm import ops as gg_ops
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttr
from repro_torch.models.transformer import lm_hidden
from test_torch_jamba import auto_ctx  # noqa: F401
from test_torch_variants import (DEEPSEEK, _close, _hold_grads, _jit,
                                 _loss_and_grads, _model, _tokens)


# ------------------------------------------------------ non-gated MoE block
def _moe_cfgs(act, n_shared):
    """tests/test_moe.py's config with a non-gated activation."""
    kw = dict(name="moe-test", family="moe", n_layers=2, d_model=32,
              n_heads=4, n_kv_heads=2, head_dim=8, d_ff=64, vocab=64,
              act=act, param_dtype="float32")
    mk = dict(n_experts=8, top_k=2, d_expert=48, n_shared=n_shared,
              capacity_factor=1.25)
    return (JModelConfig(moe=JMoECfg(**mk), **kw),
            ModelConfig(moe=MoECfg(**mk), **kw))


@pytest.mark.parametrize("act,n_shared", [("relu2", 0), ("gelu", 1)])
def test_nongated_moe_block_and_decode_match_jax(act, n_shared, auto_ctx,
                                                monkeypatch):
    """``moe_block`` (out and router stats, capacity 1.25 dropping slots)
    and ``moe_decode`` with a non-gated FFN, with and without a shared
    expert: the tree has no ``w_gate``/``ws_gate``, and each expert FFN
    takes two grouped GEMMs."""
    jcfg, tcfg = _moe_cfgs(act, n_shared)
    jp = prm.materialize(jmoe.moe_defs(jcfg), jax.random.PRNGKey(0))
    assert "w_gate" not in jp and "ws_gate" not in jp
    tp = {n: torch.from_numpy(np.array(v)) for n, v in jp.items()}
    calls = []

    def counted(a, w):
        calls.append(tuple(w.shape))
        return gg_ops.grouped_gemm_autograd(a, w)
    monkeypatch.setattr(tmoe, "grouped_gemm_autograd", counted)
    x = np.random.default_rng(2).normal(size=(2, 32, 32)).astype(np.float32)
    got, stats = tmoe.moe_block(tcfg, tp, torch.from_numpy(x))
    assert calls == [(8, 32, 48), (8, 48, 32)]
    want, jstats = _jit(lambda p, x: jmoe.moe_block(
        jcfg, p, x, auto_ctx))(jp, jnp.asarray(x))
    _close(got, want)
    _close(stats, jstats, 1e-6)
    xd = np.random.default_rng(3).normal(size=(4, 32)).astype(np.float32)
    got = tmoe.moe_decode(tcfg, tp, torch.from_numpy(xd))
    want = _jit(lambda p, x: jmoe.moe_decode(jcfg, p, x, auto_ctx))(
        jp, jnp.asarray(xd))
    _close(got, want)


# ------------------------------------------------------------ windowed MLA
def test_windowed_mla_loss_and_grads_match_jax(auto_ctx):
    """deepseek-v2 smoke with a window of 16 on every other layer (the
    batch is 32 tokens, so the window cuts): the loss, ``moe_aux`` and
    every gradient leaf against ``jax.value_and_grad``; serving refuses
    it, naming the reference's fault."""
    jcfg, tcfg, _, _ = _model("mla-window", DEEPSEEK)
    assert [bc.window for bc in ttr.block_cfgs(tcfg)][:2] == [16, 0]
    ttr.check_trainable(tcfg)
    with pytest.raises(NotImplementedError, match="mla_prefill ignores"):
        ttr.check_supported(tcfg)
    got, want, tp = _loss_and_grads("mla-window", auto_ctx, DEEPSEEK)
    _hold_grads(got, want, tp)


def test_jax_windowed_mla_prefill_ignores_the_window(auto_ctx):
    """The reference's fault that keeps windowed MLA from being served:
    JAX's ``prefill`` of a windowed MLA model gives the logits of the same
    model without a window (``mla_prefill`` never takes it), where the
    window does change the forward that training runs (its loss is held
    against JAX's in the test above)."""
    jcfg, tcfg, jp, tp = _model("mla-window", DEEPSEEK)
    jfull = dataclasses.replace(jcfg, sliding_window=0,
                                local_global_period=0)
    toks = _tokens(jcfg.vocab, (1, 24), 4)
    lw, lf = [_jit(lambda p, t, c=c: jpre.prefill(c, p, t, auto_ctx)[0])(
        jp, jnp.asarray(toks)) for c in (jcfg, jfull)]
    np.testing.assert_array_equal(np.asarray(lw), np.asarray(lf))
    tfull = dataclasses.replace(tcfg, sliding_window=0,
                                local_global_period=0)
    with torch.no_grad():
        hw, hf = [lm_hidden(c, tp, torch.from_numpy(toks))[0]
                  for c in (tcfg, tfull)]
    assert float((hw - hf).abs().max()) > 1e-3
