"""The serving mesh (``repro/launch/mesh.py``): a ``(data, model)``
``DeviceMesh`` over the ranks that ``torchrun`` or ``torch.multiprocessing``
started, and the :class:`~repro_torch.sharding.axes.ShardCtx` over it.
:func:`spawn_ranks` starts such ranks itself (spawned processes, one per
card, or gloo ranks on the host) and runs one function on each.

A function, not a module constant: importing this module touches no
process group. The process group comes from the caller (``torchrun``'s
environment, or ``init_process_group`` with an address, rank and world
size); with none, ``make_mesh`` starts it from the environment. The port
keeps no hardware constants here: any rate it needs is read from the
card, with the card's name and power limit.
"""
from __future__ import annotations

import os
import socket
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.distributed.device_mesh import init_device_mesh

from repro_torch.sharding.axes import DEFAULT_RULES, ShardCtx


def make_mesh(data: int = 1, model: int = 1, *, device_type: str = "cuda"):
    """The ``(data, model)`` mesh over every rank of the process group
    (started from the environment, NCCL on ``"cuda"``, gloo on ``"cpu"``,
    where none is running), rank r at coordinate ``(r // model, r %
    model)``. On ``"cuda"`` each rank takes the card of its local rank
    (``LOCAL_RANK``, else the rank modulo the cards it sees); a rank that
    finds no card raises."""
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("a cuda mesh needs a card on every rank")
    if not dist.is_initialized():
        dist.init_process_group("nccl" if device_type == "cuda" else "gloo")
    if device_type == "cuda":
        local = int(os.environ.get("LOCAL_RANK",
                                   dist.get_rank() % torch.cuda.device_count()))
        torch.cuda.set_device(local)
    world = dist.get_world_size()
    if data * model != world:
        raise ValueError(f"a ({data}, {model}) mesh needs {data * model} "
                         f"ranks, the process group has {world}")
    return init_device_mesh(device_type, (data, model),
                            mesh_dim_names=("data", "model"))


def make_ctx(data: int = 1, model: int = 1, *,
             device_type: str = "cuda") -> ShardCtx:
    """:func:`make_mesh` and the :class:`ShardCtx` over it, with
    :data:`DEFAULT_RULES`."""
    return ShardCtx(mesh=make_mesh(data, model, device_type=device_type),
                    rules=dict(DEFAULT_RULES))


def free_port() -> int:
    """A TCP port on localhost that nothing listens on now."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, fn, world: int, device_type: str,
               init_method: str, args: tuple) -> None:
    backend = "nccl" if device_type == "cuda" else "gloo"
    if device_type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    else:        # host ranks (tests, rehearsals) share the host's cores
        torch.set_num_threads(1)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world)
    try:
        fn(make_ctx(1, world, device_type=device_type), *args)
    finally:
        dist.destroy_process_group()


def spawn_ranks(fn, model: int, *args, device_type: str = "cuda",
                init_method: str | None = None,
                timeout: float | None = None) -> None:
    """Run ``fn(ctx, *args)`` on ``model`` spawned ranks of a ``(1,
    model)`` mesh: NCCL ranks, one per card, on ``"cuda"``; gloo ranks on
    ``"cpu"``. ``fn`` and ``args`` are pickled (``fn`` by its import
    path). ``init_method`` is the rendezvous (default
    ``tcp://localhost:<a free port>``; ``file://`` paths keep concurrent
    runs apart). A rank that raises ends the others and raises here; past
    ``timeout`` seconds every rank is killed and :class:`TimeoutError`
    raised (a rank waiting in a collective that another never enters
    waits forever)."""
    init_method = init_method or f"tcp://localhost:{free_port()}"
    procs = mp.start_processes(
        _rank_main, args=(fn, model, device_type, init_method, args),
        nprocs=model, join=False, start_method="spawn")
    deadline = None if timeout is None else time.monotonic() + timeout
    try:
        while not procs.join(timeout=1.0):
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(f"{model} ranks of {fn.__name__} did not "
                                   f"finish within {timeout} s")
    finally:
        for p in procs.processes:
            if p.is_alive():
                p.kill()
            p.join()
