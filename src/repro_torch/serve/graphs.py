"""The decode quantum as one device program: CUDA graphs of the in-place
quantum (``decode.decode_quantum``), one per key, the counterpart of the
JAX engine's ``jax.jit(decode_loop_fn(...), donate_argnums=...)`` and its
compile cache.

The engine keys a graph by the live page-table width (its power-of-two
buckets; one key for the dense engine and for a model without a page
pool); temperature, top-k/p and the quantum are fixed per engine. The
first quantum of a key runs eagerly on a side stream (the warm-up, which
also makes the paged kernels' arrival counters of that stream, sets each
kernel's shared-memory attribute at its first launch and gives cuBLAS its
workspace on that stream) and is then captured on the same stream, so the
model's state changes once: the capture itself launches nothing. Every
later quantum of that key is one ``replay`` on the current stream. All the
graphs share one memory pool. The sampling generator is registered with
each graph, so a replay draws from the generator's current Philox offset
and advances it as the eager draws would.

A graph fixes every pointer it reads at capture (kernel arguments, the
TMA tensor maps built from them), so the function it captures must read
and write the same storage at every call: the engine's static slot
state, page-table buffers, cache (pools, dense rows and rings, written in
place; ring slots computed on the device from ``pos``) and output buffer.

The kernel wrappers count launches in Python, which a replay does not
run. So each capture records the change of the capturing thread's own
count of every wrapper (:data:`COUNTERS`, ``kernels/_launches.py``) while
it ran, takes that change back from the global counts (the capture
launched nothing), and every replay adds it: the counts go on counting
kernel launches on the card, and the launches of an engine stepping in
another thread meanwhile neither enter the capture's change nor leave the
counts.

On a mesh (``Engine(ctx=)``) the quantum holds the model's NCCL
collectives, and a graph captures them with the kernels: every rank runs
the same quanta with the same keys, so every rank captures the same
sequence of collectives and every replay meets its peers' replays. The
warm-up is each key's first run and no quantum's collective is a
communicator's first (prefill ran before), so no communicator is made
inside a capture.

A capture or replay that fails raises; nothing falls back to the eager
loop. Capture runs under ``capture_error_mode="thread_local"``: a call
the capture forbids (a host-to-device copy, a synchronize) raises in the
capturing thread, while engines stepping in other threads on their own
streams (``MultiEngine``'s concurrent tiers) go on.
"""
from __future__ import annotations

import time
from typing import Callable, Hashable

import torch

from repro_torch.kernels import _launches
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.gemm import ops as gemm_ops
from repro_torch.kernels.grouped_gemm import ops as gg_ops
from repro_torch.kernels.paged_attention import ops as paged_ops
from repro_torch.kernels.selective_scan import ops as scan_ops
from repro_torch.kernels.ssd import ops as ssd_ops

# (module, name) of every kernel wrapper's launch count
COUNTERS = ((paged_ops, "launches"), (paged_ops, "mla_launches"),
            (gg_ops, "launches"), (flash_ops, "launches"),
            (flash_ops, "lse_launches"), (flash_ops, "bwd_launches"),
            (gemm_ops, "launches"), (ssd_ops, "launches"),
            (scan_ops, "launches"))


def launch_counts() -> tuple[int, ...]:
    """The wrappers' launch counts, in :data:`COUNTERS` order."""
    return tuple(getattr(mod, name) for mod, name in COUNTERS)


def thread_launch_counts() -> tuple[int, ...]:
    """The calling thread's own launch counts, in :data:`COUNTERS` order."""
    return tuple(_launches.thread_count(mod.__name__, name)
                 for mod, name in COUNTERS)


def add_launches(delta: tuple[int, ...]) -> None:
    with _launches.lock:
        for (mod, name), d in zip(COUNTERS, delta):
            if d:
                setattr(mod, name, getattr(mod, name) + d)


def counted(fn: Callable[[], None]) -> tuple[int, ...]:
    """Run ``fn`` and return the change of this thread's launch counts
    while it ran, taken back from the global counts (what a capture
    records: it launches nothing). Other threads' launches meanwhile stay
    counted and out of the change."""
    before = thread_launch_counts()
    try:
        fn()
    finally:
        delta = tuple(a - b for a, b in zip(thread_launch_counts(), before))
        add_launches(tuple(-d for d in delta))
    return delta


class DecodeGraphs:
    """CUDA graphs of one function per key, captured at the key's first
    :meth:`run` and replayed at every later one. ``generator`` is the
    generator the function samples from (registered with every graph).
    ``captures`` and ``capture_seconds`` count the captures and their wall
    time, warm-up included."""

    def __init__(self, device, generator: torch.Generator):
        self.device = torch.device(device)
        self.generator = generator
        self.captures = 0
        self.capture_seconds = 0.0
        self._graphs: dict[Hashable, tuple[object, tuple[int, ...]]] = {}
        self._pool = None
        self._stream = None

    def run(self, key: Hashable, fn: Callable[[], None]) -> bool:
        """Run ``fn`` once: replay its graph of ``key``, or, at the key's
        first call, run it eagerly and capture it. True if this call
        captured."""
        entry = self._graphs.get(key)
        if entry is not None:
            graph, delta = entry
            graph.replay()
            add_launches(delta)
            return False
        t0 = time.perf_counter()
        self._graphs[key] = self._capture(fn)
        self.captures += 1
        self.capture_seconds += time.perf_counter() - t0
        return True

    def _capture(self, fn: Callable[[], None]):
        """Warm up ``fn`` on the side stream (the quantum's one real run),
        then capture it there → (graph, launch-count change per replay)."""
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
            self._pool = torch.cuda.graph_pool_handle()
        side, cur = self._stream, torch.cuda.current_stream(self.device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            fn()
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(self.generator)

        def capture():
            # capture_begin/end, not ``torch.cuda.graph``: its entry
            # synchronizes the device and empties the allocator's cache,
            # which a capture in another engine's thread forbids
            with torch.cuda.stream(side):
                graph.capture_begin(pool=self._pool,
                                    capture_error_mode="thread_local")
                try:
                    fn()
                finally:
                    graph.capture_end()

        delta = counted(capture)
        cur.wait_stream(side)
        return graph, delta
