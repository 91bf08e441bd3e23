"""HBB — Heterogeneous Building Blocks (the paper's §3 library), in Python
(copy of ``repro/core/hbb.py``).

Faithful port of the paper's API surface:

    body = Body()                      # operatorCPU / operatorFPGA
    hs = Dynamic.get_instance(params)  # Fig. 2 line 8
    hs.parallel_for(begin, end, body)  # Fig. 2 line 10

The engine is the paper's two-stage pipeline (Fig. 1): stage S1 partitions
the remaining iteration space and dispatches a chunk to a free resource
(token-limited, one token per resource); stage S2 records the chunk's
service time and updates the relative-speed factor ``f`` via
:class:`~repro_torch.core.tracker.ThroughputTracker`. Chunk sizes
follow :mod:`repro_torch.core.chunking` — fixed ``S_f`` for
accelerator-class resources, the adaptive §3.2 law for core-class
resources.

Resources are *device tiers* here: a kernel launched on the card, a
host-CPU worker, or a calibrated simulator — anything with a
``(begin, end) → None`` body.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

from repro_torch.core.chunking import (accelerator_chunk, cpu_chunk,
                                      proportional_split)
from repro_torch.core.tracker import ThroughputTracker


@dataclass
class Params:
    """Command-line-style scheduler parameters (paper Fig. 2 / §3.1)."""
    num_cpu_tokens: int = 2        # <num_cpu_t>  — CC count
    num_fpga_tokens: int = 1       # <num_fpga_t> — 0 disables the accelerator
    fpga_chunk: int = 64           # <fpga_chunksize> — S_f
    f0: float = 8.0                # initial relative-speed prior
    min_cpu_chunk: int = 1
    scheduler: str = "dynamic"     # dynamic | static | oracle


class Body:
    """User kernel: same iteration body for both device classes (§3.1)."""

    def operatorCPU(self, begin: int, end: int) -> None:  # noqa: N802 (paper API)
        raise NotImplementedError

    def operatorFPGA(self, begin: int, end: int) -> None:  # noqa: N802
        raise NotImplementedError


@dataclass
class Resource:
    name: str
    kind: str                          # "accelerator" | "core"
    run: Callable[[int, int], None]    # bound to Body.operator*


@dataclass
class ChunkRecord:
    resource: str
    begin: int
    end: int
    t_start: float
    t_end: float


@dataclass
class RunReport:
    records: list[ChunkRecord] = field(default_factory=list)
    wall_time: float = 0.0
    f_final: float = 0.0

    def iters_by_kind(self, resources: dict[str, str]) -> dict[str, int]:
        out: dict[str, int] = {}
        for r in self.records:
            k = resources[r.resource]
            out[k] = out.get(k, 0) + (r.end - r.begin)
        return out

    def busy_time(self, name: str) -> float:
        return sum(r.t_end - r.t_start for r in self.records
                   if r.resource == name)


class Dynamic:
    """The paper's dynamic heterogeneous scheduler (singleton per Params)."""

    _instance: Optional["Dynamic"] = None

    def __init__(self, params: Params):
        self.params = params

    @classmethod
    def get_instance(cls, params: Params) -> "Dynamic":
        if cls._instance is None or cls._instance.params != params:
            cls._instance = cls(params)
        return cls._instance

    # -- public API --------------------------------------------------------
    def parallel_for(self, begin: int, end: int, body: Body,
                     resources: Optional[list[Resource]] = None) -> RunReport:
        resources = resources or self._default_resources(body)
        if not resources:
            raise ValueError("no resources enabled")
        if self.params.scheduler == "dynamic":
            return self._run_dynamic(begin, end, resources)
        if self.params.scheduler == "static":
            return self._run_static(begin, end, resources)
        if self.params.scheduler == "oracle":
            return self._run_static(begin, end, resources, use_f=True)
        raise ValueError(self.params.scheduler)

    # -- resource construction ---------------------------------------------
    def _default_resources(self, body: Body) -> list[Resource]:
        res = []
        for i in range(self.params.num_fpga_tokens):
            res.append(Resource(f"FC{i}", "accelerator", body.operatorFPGA))
        for i in range(self.params.num_cpu_tokens):
            res.append(Resource(f"CC{i}", "core", body.operatorCPU))
        return res

    # -- dynamic engine: S1 dispatch / S2 accounting ------------------------
    def _run_dynamic(self, begin: int, end: int,
                     resources: list[Resource]) -> RunReport:
        p = self.params
        n_cores = sum(1 for r in resources if r.kind == "core")
        tracker = ThroughputTracker({r.name: r.kind for r in resources},
                                    f0=p.f0)
        report = RunReport()
        lock = threading.Lock()        # guards `next_iter` (the white region)
        next_iter = begin
        t0 = time.perf_counter()

        def s1_take(kind: str) -> tuple[int, int]:
            """Stage S1: claim the next chunk for a resource class."""
            nonlocal next_iter
            with lock:
                r = end - next_iter
                if r <= 0:
                    return (0, 0)
                if kind == "accelerator":
                    c = accelerator_chunk(p.fpga_chunk, r)
                else:
                    c = cpu_chunk(p.fpga_chunk, tracker.f(), r, max(n_cores, 1),
                                  p.min_cpu_chunk)
                b = next_iter
                next_iter += c
                return (b, b + c)

        def worker(res: Resource) -> None:
            while True:
                b, e = s1_take(res.kind)
                if e <= b:
                    return
                ts = time.perf_counter()
                res.run(b, e)
                te = time.perf_counter()
                tracker.record(res.name, e - b, te - ts)   # stage S2
                with lock:
                    report.records.append(
                        ChunkRecord(res.name, b, e, ts - t0, te - t0))

        threads = [threading.Thread(target=worker, args=(r,), daemon=True)
                   for r in resources]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        report.wall_time = time.perf_counter() - t0
        report.f_final = tracker.f()
        return report

    # -- static / oracle baselines (paper comparison points) ----------------
    def _run_static(self, begin: int, end: int, resources: list[Resource],
                    use_f: bool = False) -> RunReport:
        p = self.params
        speeds = [(p.f0 if use_f else 1.0) if r.kind == "accelerator" else 1.0
                  for r in resources]
        split = proportional_split(end - begin, speeds)
        report = RunReport()
        t0 = time.perf_counter()
        bounds = []
        b = begin
        for c in split:
            bounds.append((b, b + c))
            b += c

        def worker(res: Resource, lo: int, hi: int) -> None:
            if hi <= lo:
                return
            ts = time.perf_counter()
            res.run(lo, hi)
            te = time.perf_counter()
            report.records.append(ChunkRecord(res.name, lo, hi, ts - t0,
                                              te - t0))

        threads = [threading.Thread(target=worker, args=(r, lo, hi),
                                    daemon=True)
                   for r, (lo, hi) in zip(resources, bounds)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        report.wall_time = time.perf_counter() - t0
        report.f_final = p.f0
        return report
