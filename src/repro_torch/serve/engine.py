"""Continuous-batching serving engine (``repro/serve/engine.py``, fast
path), paged or dense.

Slot-based: a fixed decode batch of ``max_slots`` sequences. Pending
requests are prefilled in power-of-2 length buckets, batched. In the paged
engine (``paged=True``) their page-aligned full-attention rows are copied
into pages of the shared pools of each layer (``(num_pages, page_size,
Hkv, dh)`` K and V for GQA, one ``(num_pages, page_size, kv_lora + rope)``
latent pool for MLA), addressed through a per-slot page table kept by a
host-side free-list allocator. In the dense engine (``paged=False``, the
JAX engine's default) every attention layer keeps ``max_len`` rows per
slot and reads no page table. Either way sliding-window layers keep a ring
per slot and Mamba layers their state, and every such dense row is
written into its slot at admit (``_admit``). A Mamba state scan would
absorb pad tokens, so such models (``pad_safe`` False: Mamba-2 stacks and
hybrids such as jamba) prefill in exact-length groups of the smallest
power-of-2 batch. The engine does not
otherwise depend on the model family. Decode runs ``decode_quantum`` tokens
per cycle with every piece of state on the device and exactly one
device-to-host read per quantum (``_host_fetch``). On the card each quantum
is one replay of a CUDA graph (``serve/graphs.py``), captured at the first
quantum of each live page-table width (a model without a page table: one
graph), as the JAX engine jits its quantum once per width: the slot state,
cache, page tables and result buffer are static tensors that every quantum
updates in place.

Admission follows the paper's scheduling law: the decode quantum is the
fixed accelerator chunk ``S_f``; the prompt-token budget admitted per
cycle is the adaptive ``S_c`` side, driven by the measured prefill:decode
throughput ratio ``f``.

On the card each engine owns a CUDA stream: its state is made there
(after the stream that made the parameters), and every ``step`` and
``abort`` enqueues there, so engines stepped from several threads
(``serve/multi_engine.py``) run side by side on one card, and a prefill
waits for its own stream alone. Each cycle returns a :class:`StepReport`,
the tier-facing surface of the pool, and ``step_deadline_s`` is the
per-step budget its supervisor reads.

On a mesh (``Engine(ctx=)``, m ranks on ``model``, data = 1) the engine
is SPMD: every rank runs this loop over its blocks of the parameters and
its ``page_size / m`` in-page offsets of every pool page, and the model's
collectives meet inside prefill and decode (inside each graph too). So
every host decision must be the same on every rank: the requests and
their order, the page allocator, the sampling generators (seeded alike,
drawing from the same whole logits) and the emitted tokens are, but the
measured times that feed the admission ratio ``f`` are not, and two ranks
that admitted different groups would wait forever in different
collectives. So rank 0's ``f`` is broadcast over the model axis at every
admission (``_admission_f``).

The port has ``Engine(fast=True)``, paged (with the paged kernel, the
port's default, or the gathered-view decode, ``paged_kernel=False``:
each slot's whole page table gathered into contiguous rows and attended
in plain torch, one graph at full table width) and dense, with or without
speculative decode (``draft_cfg``, ``draft_params``, ``spec_k``: a draft
on a dense cache of its own proposes, the target verifies and commits,
each quantum of rounds still one graph per live width and one host read;
any target the engine serves, Mamba-1 hybrids included);
:func:`make_engine` builds one over fresh parameters with the JAX default
``paged=False``. ``fast=False`` is not ported. The kernels are built when
an engine is constructed on the card, so no timed interval includes a
build.
"""
from __future__ import annotations

import contextlib
import time
from collections import Counter
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.core.chunking import cpu_chunk
from repro_torch.core.tracker import ThroughputTracker
from repro_torch.kernels import _build
from repro_torch.models.transformer import (block_cfgs, check_sharded,
                                            check_supported)
from repro_torch.params import init_params
from repro_torch.serve.decode import (_sample_tokens, decode_quantum,
                                     spec_decode_quantum)
from repro_torch.serve.graphs import DecodeGraphs
from repro_torch.serve.kv_cache import (cache_defs, cache_kinds, make_cache,
                                        paged_cache_defs)
from repro_torch.serve.prefill import bucket_len, prefill
from repro_torch.sharding.axes import model_shard
from repro_torch.sharding.collectives import broadcast
from repro_torch.sharding.params import check_local


class PromptTooLongError(ValueError):
    """Raised at ``submit()`` for a prompt the engine can never schedule:
    an ``n``-token prompt needs ``n < max_len`` (one decode slot after
    prefill)."""


class EngineStallError(RuntimeError):
    """``run()``/``drain()`` made no forward progress for far longer than
    the outstanding workload warrants (see ``Engine._guard_limit``): a
    scheduling bug or slot/pool starvation, not a slow model."""


class RequestFailedError(RuntimeError):
    """Terminal per-request failure: the request exhausted its retry budget
    (or the pool stalled) and was dead-lettered instead of being retried
    forever.

    Never raised out of ``MultiEngine.run``: the pool records an instance
    in ``MultiEngine.dead_letters[rid]`` and stops tracking the request;
    ``Request.done`` stays False and ``Request.out`` holds whatever prefix
    was emitted before the final failure."""


def worst_case_pages(prompt_len: int, max_new: int, decode_quantum: int,
                     max_len: int, page_size: int) -> int:
    """Worst-case pages a request can ever be granted: its context can reach
    prompt+max_new-1, plus quantum-granularity slack for the frozen-slot
    scribble positions, all capped at max_len."""
    end = min(prompt_len + max_new - 1 + decode_quantum, max_len)
    return max(1, -(-end // page_size))


def _host_fetch(x: torch.Tensor) -> np.ndarray:
    """Every device→host read of the engine goes through here, so tests can
    count them (one per decode quantum, one per admitted prefill group)."""
    return x.cpu().numpy()


@dataclass
class Request:
    """One generation request: ``prompt`` token ids (non-empty, shorter than
    ``max_len``), a decode budget ``max_new`` (the first token is sampled at
    prefill), the generated ``out`` and ``done``."""
    rid: int
    prompt: list[int]
    max_new: int = 16
    out: list[int] = field(default_factory=list)
    done: bool = False


@dataclass
class StepReport:
    """What one engine cycle did, the tier-facing throughput surface:
    ``MultiEngine`` feeds ``(decoded, dt)`` of warm cycles into its shared
    tracker.

    ``admitted`` requests moved into slots; ``decoded`` tokens emitted;
    ``dt`` the wall seconds of the decode quantum (the kernels are built at
    construction, so no interval measures a build); ``warm`` False for a
    quantum that captured a graph (the JAX engine's quantum that compiled):
    it measures the capture, not the tier. ``accepted`` and ``proposed``
    are the draft tokens a speculative engine kept and tried (spec_k for
    each round a slot was active), 0 for an engine without a draft."""
    admitted: int = 0
    decoded: int = 0
    dt: float = 0.0
    warm: bool = True
    accepted: int = 0
    proposed: int = 0


class PageAllocator:
    """Host-side free-list allocator over the shared KV page pool.

    Page 0 is a reserved trash page: table rows of empty slots point at it,
    so the masked scribbles of inactive decode rows never touch a live
    page. Admission reserves a worst-case page budget (``commit``) per
    request; pages are handed out lazily (``grow_to``). The invariant
    ``sum(committed - count) <= len(free)`` makes every ``grow_to``
    infallible — pool pressure surfaces only as admission backpressure.
    """

    def __init__(self, num_pages: int, max_slots: int, pages_per_slot: int):
        if num_pages - 1 < pages_per_slot:
            raise ValueError(
                f"pool of {num_pages} pages (1 reserved) cannot hold one "
                f"full {pages_per_slot}-page context")
        self.num_pages = num_pages
        self.free = list(range(num_pages - 1, 0, -1))   # pop() → low pages
        self.table = np.zeros((max_slots, pages_per_slot), np.int32)
        self.count = np.zeros(max_slots, np.int32)      # pages held per slot
        self.committed = np.zeros(max_slots, np.int32)  # worst-case budget
        self.total_grants = 0                           # page reuse evidence

    @property
    def usable_pages(self) -> int:
        return self.num_pages - 1

    def outstanding(self) -> int:
        """Pages promised to live slots but not yet handed out."""
        return int((self.committed - self.count).sum())

    def can_commit(self, n_pages: int) -> bool:
        return len(self.free) - self.outstanding() >= n_pages

    def commit(self, slot: int, n_pages: int) -> None:
        if self.committed[slot] or self.count[slot]:
            raise RuntimeError(f"slot {slot} already holds pages")
        if not self.can_commit(n_pages):
            raise RuntimeError(
                f"admitted past pool capacity ({n_pages} pages, "
                f"{len(self.free)} free, {self.outstanding()} outstanding)")
        self.committed[slot] = n_pages

    def grow_to(self, slot: int, n_pages: int) -> None:
        if n_pages > self.committed[slot]:
            raise RuntimeError(
                f"slot {slot}: grant of {n_pages} pages exceeds the "
                f"committed budget {int(self.committed[slot])}")
        while self.count[slot] < n_pages:
            self.table[slot, self.count[slot]] = self.free.pop()
            self.count[slot] += 1
            self.total_grants += 1

    def release(self, slot: int) -> None:
        for t in range(int(self.count[slot])):
            self.free.append(int(self.table[slot, t]))
        self.table[slot, :] = 0                         # back to trash page
        self.count[slot] = 0
        self.committed[slot] = 0

    def check(self) -> None:
        """Pool conservation invariant: every usable page is exactly once
        either on the free list or held by exactly one slot. Raises
        :class:`RuntimeError` naming the offending pages."""
        held = [int(self.table[s, t])
                for s in range(self.table.shape[0])
                for t in range(int(self.count[s]))]
        seen = sorted(self.free + held)
        want = list(range(1, self.num_pages))
        if seen != want:
            c = Counter(seen)
            dup = sorted(p for p, k in c.items() if k > 1)
            lost = sorted(set(want) - set(c))
            bad = sorted(set(seen) - set(want))
            raise RuntimeError(
                f"page pool invariant violated: leaked={lost} "
                f"double-held={dup} out-of-range={bad}")
        if any(self.count[s] > self.committed[s]
               for s in range(len(self.count))):
            raise RuntimeError(
                f"page pool invariant violated: a slot holds more pages "
                f"than its commit (count={self.count.tolist()}, "
                f"committed={self.committed.tolist()})")


class Engine:
    def __init__(self, cfg: ModelConfig, params, *, device=None,
                 max_slots: int = 4, max_len: int = 128, eos_id: int = -1,
                 decode_quantum: int = 8, prefill_batch: int | None = None,
                 min_bucket: int = 16, paged: bool = True,
                 page_size: int = 16, num_pages: int | None = None,
                 paged_kernel: bool = True, temperature: float = 0.0,
                 top_k: int = 0, top_p: float = 0.0,
                 sample_seed: int = 0, graphs: bool | None = None,
                 draft_cfg: ModelConfig | None = None, draft_params=None,
                 spec_k: int = 0, step_deadline_s: float | None = None,
                 ctx=None):
        """Build a serving engine over an existing parameter tree
        (``params.init_params`` or ``params.params_from_numpy``) that lies
        on ``device`` (the card unless ``device="cpu"``).

        ``max_slots`` concurrent streams of up to ``max_len`` tokens each;
        ``decode_quantum`` tokens per decode cycle (one host read each);
        ``prefill_batch`` rows per batched prefill (default ``max_slots``);
        ``min_bucket`` the smallest prompt-length bucket. ``paged`` serves
        full-attention K/V from a shared page pool through a per-slot page
        table (False: dense ``max_slots × max_len`` rows, no table):
        ``page_size`` tokens per page, dividing ``max_len``; ``num_pages``
        pool size including the trash page 0 (default: every slot at full
        ``max_len``). ``paged_kernel`` (a bool) reads the pools through the
        paged kernels (True) or as gathered views in plain torch (False,
        JAX's escape hatch: the whole table, one graph). ``temperature`` 0
        decodes greedily, > 0 samples on the device with top-k / top-p
        truncation, from ``sample_seed``.
        ``graphs`` (default: on the card) runs each decode quantum as one
        replay of a CUDA graph per live page-table width; False runs the
        eager loop, which the CPU always does (True there raises).
        ``draft_cfg`` turns on speculative decode: a little draft model
        (full attention, the target's vocab) proposes ``spec_k`` tokens a
        round from a dense cache of its own, and the target verifies them
        in one batched pass (``decode.spec_decode_loop``), so a round emits
        1 to ``spec_k + 1`` tokens; greedy streams are the target-only
        engine's. ``draft_params`` must lie on ``device`` (None:
        ``init_params(draft_cfg, seed=0)``; ``models/draft.py`` builds an
        aligned pair from the target). ``step_deadline_s`` is the advisory
        wall-clock budget of one ``step`` (None: unbounded) that
        ``MultiEngine``'s watchdog reads; the engine never preempts a
        quantum. ``ctx`` (``sharding/axes.py::ShardCtx``) serves across the
        ranks of its ``model`` axis (:meth:`_check_mesh`): ``params`` are
        this rank's blocks (``init_params(..., ctx=ctx)``), and every rank
        builds its engine with the same arguments and runs the same calls.
        """
        check_supported(cfg)
        self.ctx = ctx
        self.msize, self.rank = model_shard(ctx)
        self.device = resolve_device(device)
        on_card = self.device.type == "cuda"
        if graphs and not on_card:
            raise ValueError(f"CUDA graphs need the card; the engine is on "
                             f"{self.device}")
        if params["embed"]["table"].device.type != self.device.type:
            raise ValueError(f"params lie on "
                             f"{params['embed']['table'].device}, the engine "
                             f"on {self.device}")
        self.cfg, self.params = cfg, params
        self.max_slots, self.max_len, self.eos_id = max_slots, max_len, eos_id
        if step_deadline_s is not None and step_deadline_s <= 0:
            raise ValueError(f"step_deadline_s must be positive or None, "
                             f"got {step_deadline_s}")
        self.step_deadline_s = step_deadline_s
        self.decode_quantum = max(1, decode_quantum)
        if temperature < 0:
            raise ValueError(f"temperature must be >= 0, got {temperature}")
        if not 0 <= top_k <= cfg.vocab:
            raise ValueError(f"top_k must be in [0, vocab={cfg.vocab}], "
                             f"got {top_k}")
        if not 0.0 <= top_p <= 1.0:
            raise ValueError(f"top_p must be in [0, 1], got {top_p}")
        self.temperature, self.top_k = float(temperature), int(top_k)
        self.top_p = float(top_p)
        if not isinstance(paged_kernel, bool):
            raise ValueError(f"paged_kernel must be a bool (JAX's impl "
                             f"strings are Pallas-only), got {paged_kernel!r}")
        self.paged_kernel = paged_kernel
        self._check_spec(cfg, draft_cfg, spec_k)
        self._check_mesh(cfg, params, paged, page_size)
        self.prefill_batch = prefill_batch or max_slots
        self.min_bucket = min_bucket
        # padded buckets are only sound when every mixer is attention: a
        # Mamba state scan would absorb the pad tokens
        self.pad_safe = all(bc.mixer == "attn" for bc in block_cfgs(cfg))
        self.paged = bool(paged)
        self.stream = None
        if self.device.type == "cuda":
            _build.build()
            for name in _build.NAMES:
                _build.load(name)
            self.stream = torch.cuda.Stream(self.device)
            self.stream.wait_stream(torch.cuda.current_stream(self.device))
        with self._on_stream():
            self._make_state(cfg, max_slots, max_len, page_size, num_pages,
                             sample_seed, on_card if graphs is None
                             else graphs)
            self._make_draft(draft_params)

    def _check_spec(self, cfg, draft_cfg, spec_k) -> None:
        """The speculative settings, validated as the JAX engine's: a draft
        with ``spec_k >= 1``, decoder-only, full attention with no window
        (its rows are written optimistically, sound only where validity is
        ``gpos <= pos`` on a dense cache), the target's vocab, and ``spec_k
        + 1`` verify rows inside the target's smallest window. Any target
        the engine serves may be verified: a Mamba layer (Mamba-1 or -2)
        steps its state over the K verify rows and stages the K states
        (``decode.py::block_verify``)."""
        self.spec = draft_cfg is not None
        if spec_k and not self.spec:
            raise ValueError("spec_k requires a draft_cfg")
        self.spec_k = int(spec_k)
        self.draft_cfg = draft_cfg
        self.tokens_per_step = self.spec_k + 1 if self.spec else 1
        self.spec_accepted = 0                 # lifetime acceptance counters
        self.spec_proposed = 0
        if not self.spec:
            return
        if spec_k < 1:
            raise ValueError(f"spec_k must be >= 1 with a draft, got "
                             f"{spec_k}")
        if draft_cfg.enc_dec:
            raise ValueError("draft must be decoder-only")
        if draft_cfg.vocab != cfg.vocab:
            raise ValueError(
                f"draft vocab {draft_cfg.vocab} != target vocab "
                f"{cfg.vocab} — proposals must be target token ids")
        check_supported(draft_cfg)
        if any(bc.mixer != "attn" or bc.window
               for bc in block_cfgs(draft_cfg)):
            raise ValueError(
                "draft must be full-attention with no sliding window: its "
                "cache rows are written optimistically, which is only sound "
                "when validity is gpos <= pos on a dense cache")
        windows = [bc.window for bc in block_cfgs(cfg)
                   if bc.mixer == "attn" and bc.window]
        if windows and min(windows) < spec_k + 1:
            raise ValueError(
                f"spec_k+1 = {spec_k + 1} verify rows exceed the target's "
                f"smallest window {min(windows)} — staged rows must all be "
                f"in-window for every verify query")

    def _check_mesh(self, cfg, params, paged, page_size) -> None:
        """A mesh serves :func:`check_sharded`'s models with page pools
        through the paged kernel, ``page_size`` a multiple of the model
        axis and data = 1 (JAX's engine checks the same), no draft, and
        ``params`` this rank's blocks. One rank checks nothing."""
        if self.ctx is None or self.msize * self.ctx.axis_size("data") == 1:
            return
        check_sharded(cfg, self.ctx)
        if not paged or not self.paged_kernel:
            raise ValueError("a sharded engine pages its K/V and reads them "
                             "through the paged kernel (paged=True, "
                             "paged_kernel=True)")
        if page_size <= 0 or page_size % self.msize:
            raise ValueError(f"page_size {page_size} must be a positive "
                             f"multiple of the model-axis size {self.msize}")
        if self.spec:
            raise ValueError("speculative decode on a mesh is not ported yet")
        check_local(params, cfg, self.ctx)

    def _admission_f(self) -> float:
        """The admission ratio ``f`` the HBB budget reads: this engine's
        tracker's, on a mesh rank 0's broadcast over the model axis, so
        that ranks whose clocks measured differently admit the same
        groups."""
        f = self.tracker.f()
        if self.msize == 1:
            return f
        t = torch.tensor([f], dtype=torch.float64, device=self.device)
        return float(broadcast(t, self.ctx).item())

    def _make_draft(self, draft_params) -> None:
        """The draft's parameters and its dense cache (one row per position
        of every slot: the draft never reads a page table)."""
        self.draft_params = self.draft_cache = None
        if not self.spec:
            return
        if draft_params is None:
            draft_params = init_params(self.draft_cfg, seed=0,
                                       device=self.device)
        if draft_params["embed"]["table"].device.type != self.device.type:
            raise ValueError(f"draft params lie on "
                             f"{draft_params['embed']['table'].device}, the "
                             f"engine on {self.device}")
        self.draft_params = draft_params
        self.draft_cache = make_cache(cache_defs(
            self.draft_cfg, max_slots=self.max_slots, max_len=self.max_len),
            self.device)

    def _on_stream(self):
        """The engine's stream as the current one (a no-op on the CPU)."""
        if self.stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self.stream)

    def _make_state(self, cfg, max_slots, max_len, page_size, num_pages,
                    sample_seed, use_graphs) -> None:
        """The page pool or dense rows, slot state and graphs, made on the
        engine's stream."""
        dev = self.device
        self.alloc = None
        self.page_table_dev = None
        if self.paged:
            if page_size <= 0:
                raise ValueError(f"page_size {page_size} must be positive")
            if max_len % page_size:
                raise ValueError(f"max_len {max_len} must be a multiple of "
                                 f"page_size {page_size}")
            self.page_size = page_size
            self.pages_per_slot = max_len // page_size
            self.num_pages = num_pages or 1 + max_slots * self.pages_per_slot
            self.alloc = PageAllocator(self.num_pages, max_slots,
                                       self.pages_per_slot)
            self.cache = make_cache(paged_cache_defs(
                cfg, num_pages=self.num_pages, page_size=page_size,
                max_slots=max_slots, max_len=max_len, msize=self.msize), dev)
            self.page_table_dev = torch.tensor(self.alloc.table, device=dev)
            # the live-width prefixes the quanta read, one static buffer each
            self._tables = {self.pages_per_slot: self.page_table_dev}
        else:
            self.cache = make_cache(cache_defs(cfg, max_slots=max_slots,
                                               max_len=max_len), dev)
        self.kinds = cache_kinds(cfg, paged=self.paged)
        self._table_dirty = False
        self.pos_host = np.zeros(max_slots, np.int64)  # device-pos mirror
        self.slot_req: list[Optional[Request]] = [None] * max_slots
        self.pending: list[Request] = []
        self.tracker = ThroughputTracker(
            {"decode": "accelerator", "prefill": "core"}, f0=2.0)
        self._last_admitted = 0
        self.quanta = 0                                # decode dispatches
        self.prefill_groups = 0                        # prefill dispatches
        self.widths_used: Counter = Counter()          # quanta per width
        # device-resident decode state
        self.tokens_dev = torch.zeros(max_slots, dtype=torch.int32,
                                      device=dev)
        self.pos_dev = torch.zeros(max_slots, dtype=torch.int32, device=dev)
        self.active_dev = torch.zeros(max_slots, dtype=torch.bool, device=dev)
        self.remaining_dev = torch.zeros(max_slots, dtype=torch.int32,
                                         device=dev)
        # the quantum's packed result: tokens, masks, (speculative: the
        # accepted proposals of each round,) then active
        NK = self.decode_quantum * self.tokens_per_step
        self._packed = torch.zeros(
            (2 * NK + (self.decode_quantum if self.spec else 0) + 1,
             max_slots), dtype=torch.int32, device=dev)
        self._gen = torch.Generator(device=dev).manual_seed(sample_seed)
        # independent stream for first-token sampling at prefill
        self._prefill_gen = torch.Generator(device=dev).manual_seed(
            sample_seed + 1)
        self.graphs = DecodeGraphs(dev, self._gen) if use_graphs else None

    def reserved_cache_bytes(self) -> int:
        """Bytes of every leaf of the engine's cache, pools and dense rows,
        rings and Mamba state (JAX ``Engine.reserved_cache_bytes``; the
        draft's rows are not counted, as JAX's)."""
        return sum(t.nbytes for layer in self.cache["layers"]
                   for t in layer.values())

    @property
    def decode_captures(self) -> int:
        """Decode quanta that captured a graph (the JAX engine's compile
        count probe): one per live page-table width used."""
        return self.graphs.captures if self.graphs is not None else 0

    # ---- admission ---------------------------------------------------------
    def submit(self, req: Request) -> None:
        n = len(req.prompt)
        if n == 0:
            raise ValueError(f"request {req.rid}: empty prompt")
        if n >= self.max_len:
            raise PromptTooLongError(
                f"request {req.rid}: prompt of {n} tokens needs at least "
                f"one decode slot; engine max_len is {self.max_len}")
        self.pending.append(req)

    def decode_throughput(self) -> float:
        """EWMA decode tokens/sec this engine has measured for itself (0.0
        until the first warm quantum)."""
        return self.tracker.throughput("decode")

    def free_slots(self) -> list[int]:
        return [i for i, r in enumerate(self.slot_req) if r is None]

    def has_work(self) -> bool:
        """True while any request is pending or occupies a decode slot."""
        return bool(self.pending) or any(r is not None for r in self.slot_req)

    def take_pending(self) -> list[Request]:
        """Hand back the not-yet-admitted queue (admitted requests stay —
        their KV lives in this engine's pool)."""
        out, self.pending = self.pending, []
        return out

    def plan_admission(self, reqs: list[Request]) -> int:
        """How many of ``reqs`` (a prefix, in order) this engine could admit
        right now: bounded by free slots net of pending work and, for a
        paged engine, by the pool's worst-case commit budget. Advisory
        only."""
        n = min(len(reqs), len(self.free_slots()) - len(self.pending))
        if n <= 0:
            return 0
        if not self.paged:
            return n
        planned = sum(self._worst_pages(r) for r in self.pending)
        k = 0
        for req in reqs[:n]:
            w = self._worst_pages(req)
            if not self.alloc.can_commit(planned + w):
                break
            planned += w
            k += 1
        return k

    def drain(self) -> None:
        """Step until no pending or admitted work remains."""
        guard, limit = 0, self._guard_limit()
        while self.has_work():
            if guard >= limit:
                raise EngineStallError(
                    f"drain made no progress after {guard} cycles "
                    f"(limit {limit}): {len(self.pending)} pending")
            self.step()
            guard += 1

    def abort(self) -> list:
        """Reclaim every admitted request without stepping the model: each
        is handed back with the tokens it already emitted, its pages (if
        paged) are released and the device-side active/remaining vectors are
        zeroed.
        Pending requests are not included (see ``take_pending``). Returns
        the reclaimed requests in slot order."""
        out = []
        for i, req in enumerate(self.slot_req):
            if req is None:
                continue
            out.append(req)
            self.slot_req[i] = None
            self._release_slot_pages(i)
            self.pos_host[i] = 0
        with self._on_stream():
            self._push_page_table()
            self.active_dev.zero_()
            self.remaining_dev.zero_()
        return out

    # ---- paged-pool bookkeeping ------------------------------------------
    @property
    def quantum_tokens(self) -> int:
        """Most tokens one decode quantum can advance a slot: each round
        emits up to ``tokens_per_step`` (1, or spec_k + 1 for a speculative
        engine). Page grants and the live table width budget this worst
        case; acceptance below 100% leaves slack."""
        return self.decode_quantum * self.tokens_per_step

    def _worst_pages(self, req: Request) -> int:
        return worst_case_pages(len(req.prompt), req.max_new,
                                self.quantum_tokens, self.max_len,
                                self.page_size)

    def _grant_quantum_pages(self, active_slots: list[int]) -> None:
        """Pre-grant every occupied slot enough pages to cover the coming
        quantum, so the decode loop never needs a device-side allocator."""
        for i in active_slots:
            end = min(int(self.pos_host[i]) + self.quantum_tokens,
                      self.max_len)
            target = -(-end // self.page_size)
            if target > self.alloc.count[i]:
                self.alloc.grow_to(i, target)
                self._table_dirty = True

    def _release_slot_pages(self, slot: int) -> None:
        if self.paged:
            self.alloc.release(slot)
            self._table_dirty = True

    def _push_page_table(self) -> None:
        if self.paged and self._table_dirty:
            # a blocking copy: the host table keeps changing
            self.page_table_dev.copy_(torch.from_numpy(self.alloc.table))
            self._table_dirty = False

    def _live_width(self, active_slots: list[int]) -> int:
        """Page-table columns handed to the decode quantum: enough pages to
        cover every active slot through the quantum, rounded up to a power
        of two and floored at 8, as the JAX engine buckets them. The kernel
        reads no page past a slot's ``pos`` either way; a stale ``pos``
        beyond the slice writes to the trash page (``_paged_write``). A
        model without a page pool (and the dense engine) reads no table:
        its quanta share one width, and so one graph, and so does the
        gathered-view decode (``paged_kernel=False``), which takes the
        whole table, as JAX's."""
        if "paged" not in self.kinds or not self.paged_kernel:
            return self.pages_per_slot if self.paged else 0
        end = max(min(int(self.pos_host[i]) + self.quantum_tokens,
                      self.max_len) for i in active_slots)
        n_live = max(-(-end // self.page_size), 8)
        return min(self.pages_per_slot, 1 << (n_live - 1).bit_length())

    def _live_page_table(self, width: int) -> Optional[torch.Tensor]:
        """The static buffer of ``width`` columns, holding the live prefix
        of the device page table (the full table is its own buffer); None
        in the dense engine."""
        if not self.paged:
            return None
        buf = self._tables.get(width)
        if buf is None:
            buf = self._tables[width] = torch.empty(
                (self.max_slots, width), dtype=torch.int32,
                device=self.device)
        if buf is not self.page_table_dev:
            buf.copy_(self.page_table_dev[:, :width])
        return buf

    def _quantum(self, page_table: Optional[torch.Tensor]) -> None:
        """One decode quantum in place on the engine's static tensors (the
        function a graph captures): the slot state, cache and packed
        result are read from and written back to ``self``; a speculative
        engine's draft cache too."""
        if self.spec:
            spec_decode_quantum(
                self.cfg, self.draft_cfg, self.params, self.draft_params,
                self.cache, self.draft_cache, self.tokens_dev, self.pos_dev,
                self.active_dev, self.remaining_dev, page_table,
                self._packed, spec_k=self.spec_k,
                num_steps=self.decode_quantum, eos_id=self.eos_id,
                max_len=self.max_len, temperature=self.temperature,
                top_k=self.top_k, top_p=self.top_p, generator=self._gen,
                paged_kernel=self.paged_kernel)
            return
        decode_quantum(
            self.cfg, self.params, self.cache, self.tokens_dev, self.pos_dev,
            self.active_dev, self.remaining_dev, page_table, self._packed,
            num_steps=self.decode_quantum, eos_id=self.eos_id,
            max_len=self.max_len, temperature=self.temperature,
            top_k=self.top_k, top_p=self.top_p, generator=self._gen,
            paged_kernel=self.paged_kernel, ctx=self.ctx)

    # ---- one engine cycle -------------------------------------------------
    def step(self) -> StepReport:
        """One engine cycle on the engine's stream: admit pending prompts
        (HBB token budget), run one decode quantum, retire finished
        slots."""
        with self._on_stream():
            return self._step()

    def _step(self) -> StepReport:
        self._last_admitted = 0
        free = self.free_slots()
        if self.pending and free:
            self._admit_pending(free)
        active_slots = [i for i, r in enumerate(self.slot_req)
                        if r is not None]
        if not active_slots:          # everything finished at prefill
            return StepReport(admitted=self._last_admitted)
        if self.paged:
            self._grant_quantum_pages(active_slots)
            self._push_page_table()
        t0 = time.perf_counter()
        width = self._live_width(active_slots)
        table = self._live_page_table(width)
        captured = False
        if self.graphs is None:
            self._quantum(table)
        else:
            captured = self.graphs.run(width, lambda: self._quantum(table))
        packed_h = _host_fetch(self._packed)           # the ONE sync
        dt = time.perf_counter() - t0
        self.quanta += 1
        self.widths_used[width] += 1
        N = self.decode_quantum
        # a speculative round emits up to tokens_per_step tokens: N·K
        # emission rows, round-major, in emission order
        NK = N * self.tokens_per_step
        toks_h = packed_h[:NK]
        msks_h = packed_h[NK:2 * NK].astype(bool)
        act_h = packed_h[-1].astype(bool)
        emitted = int(msks_h.sum())
        accepted = proposed = 0
        if self.spec:
            accepted = int(packed_h[2 * NK:2 * NK + N].sum())
            # a round's first emission row is "active at the round's start":
            # each active round made spec_k proposals
            rounds = int(msks_h.reshape(N, self.tokens_per_step, -1)[
                :, 0].sum())
            proposed = self.spec_k * rounds
            self.spec_accepted += accepted
            self.spec_proposed += proposed
        # a quantum that captured does not measure decode speed: feeding it
        # to the tracker would skew the admission ratio f (the JAX engine's
        # warm rule)
        if emitted and not captured:
            self.tracker.record("decode", emitted, dt)
        self.pos_host += msks_h.sum(axis=0)
        for q in range(NK):
            for i in active_slots:
                if msks_h[q, i]:
                    self.slot_req[i].out.append(int(toks_h[q, i]))
        for i in active_slots:
            if not act_h[i]:
                self.slot_req[i].done = True
                self.slot_req[i] = None
                self._release_slot_pages(i)
        return StepReport(admitted=self._last_admitted, decoded=emitted,
                          dt=dt, warm=not captured, accepted=accepted,
                          proposed=proposed)

    def _admit_pending(self, free: list[int]) -> None:
        """HBB chunking law over token units: the decode quantum is the
        fixed accelerator chunk (S_f = quantum × slots tokens); the prompt-
        token budget admitted this cycle is the adaptive S_c side. A paged
        engine's admission also stops at the pool's worst-case page
        budget."""
        r_tokens = sum(len(q.prompt) for q in self.pending)
        budget = cpu_chunk(S_f=self.quantum_tokens * self.max_slots,
                           f=self._admission_f(), r=r_tokens, n_cores=1)
        take: list[Request] = []
        planned_pages = 0
        while self.pending and len(take) < len(free):
            req = self.pending[0]
            n = len(req.prompt)
            if take and budget < n:            # always admit ≥ 1
                break
            if self.paged:
                W = self._worst_pages(req)
                if not self.alloc.can_commit(planned_pages + W):
                    break                      # pool backpressure
                planned_pages += W
            budget -= n
            take.append(self.pending.pop(0))
        if not take:
            return
        self._last_admitted = len(take)
        groups: dict[int, list[Request]] = {}
        for req in take:
            b = (bucket_len(len(req.prompt), min_bucket=self.min_bucket,
                            max_bucket=self.max_len)
                 if self.pad_safe else len(req.prompt))
            groups.setdefault(b, []).append(req)
        ptoks = 0
        pdt = 0.0
        for Sb in sorted(groups):
            grp = groups[Sb]
            for k0 in range(0, len(grp), self.prefill_batch):
                chunk = grp[k0:k0 + self.prefill_batch]
                pdt += self._prefill_group(Sb, chunk, free)
                ptoks += sum(len(q.prompt) for q in chunk)
        if ptoks:
            self.tracker.record("prefill", ptoks, pdt)

    def _prefill_group(self, Sb: int, reqs: list[Request],
                       free: list[int]) -> float:
        """Prefill + admit one bucket group; returns the device seconds of
        the prefill and the admit copy (the engine's stream synchronized:
        another engine's work on the card is not waited for). Padded
        buckets use the fixed ``prefill_batch`` rows, exact-length groups
        the smallest power-of-2 batch."""
        P = (self.prefill_batch if self.pad_safe
             else 1 << (len(reqs) - 1).bit_length())
        toks = np.zeros((P, Sb), np.int32)
        pl = np.ones(P, np.int32)
        slots = np.zeros(len(reqs), np.int64)
        for j, req in enumerate(reqs):
            toks[j, :len(req.prompt)] = req.prompt
            pl[j] = len(req.prompt)
            slots[j] = free.pop(0)
        page_src = (self._alloc_group_pages(Sb, reqs, slots) if self.paged
                    else None)
        dev = self.device
        t0 = time.perf_counter()
        pl_dev = torch.tensor(pl, device=dev)
        toks_dev = torch.tensor(toks, device=dev)
        logits, new_cache = prefill(
            self.cfg, self.params, toks_dev, max_len=self.max_len,
            prompt_len=pl_dev,
            page_size=self.page_size if self.paged else None, ctx=self.ctx)
        draft_rows = None
        if self.spec:      # the draft's dense rows of the same prompts
            _, draft_rows = prefill(self.draft_cfg, self.draft_params,
                                    toks_dev, max_len=self.max_len,
                                    prompt_len=pl_dev)
        first = _sample_tokens(logits, self._prefill_gen,
                               temperature=self.temperature, top_k=self.top_k,
                               top_p=self.top_p)
        self._admit(new_cache, first, pl_dev, reqs, slots, page_src,
                    draft_rows)
        if self.stream is not None:
            self.stream.synchronize()
        dt = time.perf_counter() - t0
        self.prefill_groups += 1
        first_h = _host_fetch(first)           # one sync per admitted group
        for j, req in enumerate(reqs):
            req.out.append(int(first_h[j]))
            if req.max_new <= 1:
                req.done = True                # budget spent at prefill
                free.insert(0, int(slots[j]))
                self._release_slot_pages(int(slots[j]))
            else:
                self.slot_req[int(slots[j])] = req
                self.pos_host[int(slots[j])] = len(req.prompt)
        return dt

    def _admit(self, new_cache, first, pl_dev, reqs, slots, page_src,
               draft_rows=None):
        """Move a prefilled group into its slots IN PLACE (``index_copy_``):
        each dense leaf (per-slot rows, rings, Mamba state, and the
        draft's rows ``draft_rows``) takes the group's rows into their slots
        in one pass, the paged layers' page-aligned rows go into their
        freshly granted pool pages, and the slot state vectors take the
        group's first token, position and budget. ``page_src``
        (num_pages,) is the flat (row · pages_per_row + page) source of
        each pool page, -1 where the group writes nothing (None in the
        dense engine)."""
        dev = self.device
        n = len(reqs)
        slot_dev = torch.tensor(slots, device=dev)
        rem = np.array([r.max_new - 1 for r in reqs], np.int32)
        act = (rem > 0) & (np.array([len(r.prompt) for r in reqs])
                           < self.max_len)
        self.tokens_dev[slot_dev] = first[:n]
        self.pos_dev[slot_dev] = pl_dev[:n]
        self.remaining_dev[slot_dev] = torch.tensor(rem, device=dev)
        self.active_dev[slot_dev] = torch.tensor(act, device=dev)
        if self.paged:
            dst = np.nonzero(page_src >= 0)[0]
            dst_dev = torch.tensor(dst, device=dev)
            src_dev = torch.tensor(page_src[dst].astype(np.int64),
                                   device=dev)
            ps = self.page_size // self.msize     # this rank's offsets
        for kind, pools, rows in zip(self.kinds, self.cache["layers"],
                                     new_cache["layers"]):
            for name, r in rows.items():
                if kind == "dense":            # per-slot rows and state
                    pools[name].index_copy_(0, slot_dev,
                                            r[:n].to(pools[name].dtype))
                    continue
                src = r.reshape((-1, ps) + tuple(r.shape[2:]))   # pool rows
                pools[name].index_copy_(0, dst_dev,
                                        src.index_select(0, src_dev))
        if draft_rows is not None:
            for pools, rows in zip(self.draft_cache["layers"],
                                   draft_rows["layers"]):
                for name, r in rows.items():
                    pools[name].index_copy_(0, slot_dev,
                                            r[:n].to(pools[name].dtype))

    def _alloc_group_pages(self, Sb: int, reqs: list[Request],
                           slots: np.ndarray) -> np.ndarray:
        """Commit each request's worst-case page budget, hand out the pages
        its prompt needs now, and build the pool-page → prefill-row source
        map the admit copy consumes."""
        ps = self.page_size
        Tb = -(-Sb // ps)                      # pages per bucket row
        page_src = np.full(self.num_pages, -1, np.int32)
        for j, req in enumerate(reqs):
            slot = int(slots[j])
            self.alloc.commit(slot, self._worst_pages(req))
            need = -(-len(req.prompt) // ps)
            self.alloc.grow_to(slot, need)
            self._table_dirty = True
            for t in range(need):
                page_src[self.alloc.table[slot, t]] = j * Tb + t
        return page_src

    def _guard_limit(self) -> int:
        """Cycle budget proportional to outstanding work: every request
        needs ≲ 1 admission cycle plus max_new/quantum decode cycles (a
        speculative round emits at least one token, so ``decode_quantum``
        bounds it, as in the JAX engine); 8× is generous slack for
        admission backpressure."""
        reqs = self.pending + [r for r in self.slot_req if r is not None]
        tokens = sum(max(1, r.max_new) for r in reqs)
        return 64 + 8 * (len(reqs) + -(-tokens // self.decode_quantum))

    def run(self, requests: list[Request]) -> list[Request]:
        for r in requests:
            self.submit(r)
        guard, limit = 0, self._guard_limit()
        while self.has_work():
            if guard >= limit:
                undone = sum(1 for r in requests if not r.done)
                raise EngineStallError(
                    f"no forward progress after {guard} cycles "
                    f"(limit {limit}): {len(self.pending)} pending, "
                    f"{undone} unfinished requests — engine scheduling bug "
                    f"or pool/slot starvation")
            self.step()
            guard += 1
        return requests


def make_engine(cfg: ModelConfig, *, seed: int = 0, device=None, ctx=None,
                **kw) -> Engine:
    """An :class:`Engine` over fresh parameters (``init_params(cfg, seed)``
    on ``device``, the card unless ``device="cpu"``; this rank's blocks of
    them on a mesh, ``ctx``). Keeps the JAX ``make_engine``'s default of a
    dense engine (``paged=False``), so the same keywords build the same
    layout in both packages."""
    kw.setdefault("paged", False)
    return Engine(cfg, init_params(cfg, seed=seed, device=device, ctx=ctx),
                  device=device, ctx=ctx, **kw)
