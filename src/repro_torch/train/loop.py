"""Fault-tolerant training loop (``repro/train/loop.py``).

Init-or-restore, periodic (async) checkpoints, per-step throughput fed to
the :class:`StragglerMonitor`, failure handling (restore the newest valid
checkpoint) and a bounded restart budget.
"""
from __future__ import annotations

import time
import traceback
from dataclasses import dataclass, field
from typing import Any, Callable, Iterator, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.straggler import StragglerMonitor
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.compression import CompressionConfig
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.step import init_state, make_train_step


@dataclass
class LoopConfig:
    ckpt_dir: str
    total_steps: int = 100
    ckpt_every: int = 20
    async_ckpt: bool = True
    max_restarts: int = 3


@dataclass
class LoopResult:
    state: Any
    history: list[dict] = field(default_factory=list)
    restarts: int = 0
    resumed_from: Optional[int] = None
    failures: list[str] = field(default_factory=list)   # tracebacks


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train_loop(cfg: ModelConfig, ocfg: OptConfig, lcfg: LoopConfig,
               data_iter: Iterator[dict],
               ccfg: CompressionConfig | None = None,
               failure_injector=None,
               on_step: Optional[Callable[[int, dict], None]] = None,
               seed: int = 0, device=None,
               microbatches: int = 1) -> LoopResult:
    """Train ``lcfg.total_steps`` steps (the card unless ``device="cpu"``).
    A step that raises restores the newest valid checkpoint (or the seeded
    initial state) and goes on, at most ``max_restarts`` times."""
    step_fn = make_train_step(cfg, ocfg, ccfg, microbatches)
    monitor = StragglerMonitor()
    result = LoopResult(state=None)
    saver = ckpt.AsyncSaver()

    def init_or_restore():
        state = init_state(cfg, seed, ccfg, ocfg, device)
        restored = ckpt.restore(lcfg.ckpt_dir, state)
        if restored is not None:
            state, at = restored
            result.resumed_from = at
            return state, at
        return state, 0

    try:
        state, step = init_or_restore()
        dev = state["params"]["final_norm"].device
        restarts = 0
        while step < lcfg.total_steps:
            try:
                batch = next(data_iter)
                if failure_injector is not None:
                    failure_injector.maybe_fail(step)
                t0 = time.perf_counter()
                state, metrics = step_fn(state, batch)
                row = {k: float(v) for k, v in metrics.items()}
                _sync(dev)
                dt = time.perf_counter() - t0
                monitor.observe("self", max(int(row.get("tokens", 0)), 1),
                                dt)
                step += 1
                row = {"step": step, "dt": dt, **row}
                result.history.append(row)
                if on_step:
                    on_step(step, row)
                if step % lcfg.ckpt_every == 0 or step == lcfg.total_steps:
                    if lcfg.async_ckpt:
                        saver.save(lcfg.ckpt_dir, state, step)
                    else:
                        ckpt.save(lcfg.ckpt_dir, state, step)
            except StopIteration:
                break
            except Exception:
                result.failures.append(traceback.format_exc())
                restarts += 1
                result.restarts = restarts
                if restarts > lcfg.max_restarts:
                    raise
                saver.wait()
                state = None
                state, step = init_or_restore()
    finally:
        saver.close()
    result.state = state
    return result
