"""Train a widened mistral-nemo-12b (2 layers, f32) a few steps through the
JAX package and through the port on the same batches, and print both
loss curves: whether a learning rate diverges at a width is a property
of the reference, not of the port, when the two curves agree.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/width_lr_probe.py \
        --d-model 3072 --lr 1e-3 [--steps 5] [--vocab 8192]

8 heads over 2 of 128, FFN 2.8·d (multiple of 64), batch 2 x 256 of
``SyntheticLM(vocab, 256, seed=0)``, AdamW with warmup 2 and a cosine to
``--steps``; parameters from the JAX initializer, carried across.
"""
from __future__ import annotations

import argparse
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import all_configs
from repro.data.synthetic import SyntheticLM
from repro.models.model import model_defs
from repro.sharding import params as prm
from repro.sharding.axes import single_device_ctx
from repro.train.optimizer import OptConfig as JOpt
from repro.train.optimizer import init_moments
from repro.train.step import make_train_step as jax_step
from repro_torch import configs as tconfigs
from repro_torch.params import params_from_numpy
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.step import make_state, make_train_step


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--d-model", type=int, required=True)
    ap.add_argument("--lr", type=float, required=True)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--vocab", type=int, default=8192)
    args = ap.parse_args()
    d = args.d_model
    shape = dict(n_layers=2, d_model=d, n_heads=8, n_kv_heads=2,
                 head_dim=128, d_ff=int(2.8 * d) // 64 * 64,
                 vocab=args.vocab, param_dtype="float32")
    jcfg = dataclasses.replace(all_configs()["mistral-nemo-12b"], **shape)
    tcfg = dataclasses.replace(tconfigs.get_config("mistral-nemo-12b"),
                               **shape)
    opt = dict(lr=args.lr, warmup_steps=2, decay_steps=args.steps)
    jp = prm.materialize(model_defs(jcfg), jax.random.PRNGKey(0))
    mom = init_moments(jp, JOpt(**opt))
    jstate = {"params": jp, "m": mom["m"], "v": mom["v"],
              "step": jnp.zeros((), jnp.int32)}
    tstate = make_state(params_from_numpy(jax.tree.map(np.asarray, jp), tcfg,
                                          device="cpu"), OptConfig(**opt))
    jstep = jax.jit(jax_step(jcfg, JOpt(**opt), single_device_ctx()))
    tstep = make_train_step(tcfg, OptConfig(**opt))
    data = SyntheticLM(args.vocab, 256, seed=0)
    jl, tl = [], []
    for _ in range(args.steps):
        b = data.batch(2)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        tstate, tm = tstep(tstate, {k: torch.from_numpy(v)
                                    for k, v in b.items()})
        jl.append(round(float(jm["loss"]), 4))
        tl.append(round(float(tm["loss"]), 4))
    print(f"d={d} lr={args.lr} ln V={np.log(args.vocab):.3f}\n  jax  {jl}\n"
          f"  port {tl}")


if __name__ == "__main__":
    main()
