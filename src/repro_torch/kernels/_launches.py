"""Kernel launch counts that stay exact when several threads launch.

Each wrapper keeps its count as a module global (``paged_attention.ops.
launches``, ...), which callers read and reset. :func:`bump` adds one to
it under :data:`lock`, so concurrent engines lose no update, and adds one
to the calling thread's own count of it. A CUDA graph capture
(``serve/graphs.py``) diffs the capturing thread's counts, so the launches
that another engine's thread makes meanwhile stay out of what the graph's
replays add.
"""
from __future__ import annotations

import sys
import threading

lock = threading.Lock()
_local = threading.local()


def _mine() -> dict[tuple[str, str], int]:
    counts = getattr(_local, "counts", None)
    if counts is None:
        counts = _local.counts = {}
    return counts


def bump(module: str, name: str) -> None:
    """Count one launch: the global ``name`` of the module named ``module``
    and the calling thread's count of it."""
    mod = sys.modules[module]
    with lock:
        setattr(mod, name, getattr(mod, name) + 1)
    mine = _mine()
    mine[(module, name)] = mine.get((module, name), 0) + 1


def thread_count(module: str, name: str) -> int:
    """The launches the calling thread has counted under ``name`` of
    ``module`` since it started."""
    return _mine().get((module, name), 0)
