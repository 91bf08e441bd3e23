"""Atomic, checksummed, resumable checkpoints (``repro/train/checkpoint.py``).

Layout: ``<dir>/step_<N>/manifest.json`` and one ``.npy`` per leaf.
Protocol: write to ``<dir>/tmp_<N>``, fsync, atomic rename, so a crash
mid-save never corrupts the previous checkpoint. Restore walks the steps
newest first and skips any checkpoint whose CRCs do not verify.
:class:`AsyncSaver` snapshots to the host and writes on a worker thread.

Leaves are tensors or Python ints (the step). numpy's ``.npy`` has no
bfloat16, so a bf16 tensor is stored as its 16-bit pattern (a uint16 view
taken through torch) and its dtype is restored from the manifest.
"""
from __future__ import annotations

import json
import os
import shutil
import zlib
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.params import tree_map

_BITS = {torch.bfloat16: (torch.int16, np.uint16)}   # stored as raw bits


def _flatten(tree, prefix=""):
    """(path, leaf) pairs in ``params.tree_map``'s order."""
    if isinstance(tree, dict):
        return [kv for k, v in tree.items()
                for kv in _flatten(v, f"{prefix}{k}/")]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree)
                for kv in _flatten(v, f"{prefix}{i}/")]
    return [(prefix.rstrip("/"), tree)]


def _to_numpy(leaf) -> tuple[np.ndarray, str]:
    if isinstance(leaf, int):
        return np.asarray(leaf, np.int64), "int"
    t = leaf.detach().cpu()
    name = str(t.dtype).removeprefix("torch.")
    if t.dtype in _BITS:
        signed, unsigned = _BITS[t.dtype]
        return t.view(signed).numpy().view(unsigned), name
    return t.numpy(), name


def _from_numpy(arr: np.ndarray, dtype: str, like):
    if dtype == "int":
        return int(arr)
    want = getattr(torch, dtype)
    if want in _BITS:
        signed, _ = _BITS[want]
        t = torch.from_numpy(arr.view(np.int16)).view(want)
    else:
        t = torch.from_numpy(arr)
    t = t.to(like.device)
    return t.requires_grad_(like.requires_grad)


def save(ckpt_dir: str, state, step: int) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = os.path.join(ckpt_dir, f"tmp_{step}")
    final = os.path.join(ckpt_dir, f"step_{step}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = {"step": step, "tensors": {}}
    for key, leaf in _flatten(state):
        arr, dtype = _to_numpy(leaf)
        fn = key.replace("/", "__") + ".npy"
        path = os.path.join(tmp, fn)
        with open(path, "wb") as f:
            np.lib.format.write_array(f, arr)
            f.flush()
            os.fsync(f.fileno())
        with open(path, "rb") as f:
            crc = zlib.crc32(f.read())
        manifest["tensors"][key] = {"file": fn, "crc": crc,
                                    "shape": list(arr.shape), "dtype": dtype}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


class AsyncSaver:
    """Saves on one worker thread. ``save`` snapshots the state to the host
    first (so training may go on changing its tensors), waits for the
    previous save, and returns the new save's future; ``wait`` re-raises
    a failed save."""

    def __init__(self):
        self._pool = ThreadPoolExecutor(max_workers=1)
        self._pending: Optional[Future] = None

    def save(self, ckpt_dir: str, state, step: int) -> Future:
        host = tree_map(lambda x: x.detach().to("cpu", copy=True)
                        if isinstance(x, torch.Tensor) else x, state)
        self.wait()
        self._pending = self._pool.submit(save, ckpt_dir, host, step)
        return self._pending

    def wait(self) -> None:
        if self._pending is not None:
            pending, self._pending = self._pending, None
            pending.result()

    def close(self) -> None:
        try:
            self.wait()
        finally:
            self._pool.shutdown()


def available_steps(ckpt_dir: str) -> list[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    steps = []
    for n in os.listdir(ckpt_dir):
        if n.startswith("step_"):
            try:
                steps.append(int(n.split("_")[1]))
            except ValueError:
                pass
    return sorted(steps)


def _verify(path: str) -> Optional[dict]:
    try:
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        for meta in manifest["tensors"].values():
            with open(os.path.join(path, meta["file"]), "rb") as f:
                if zlib.crc32(f.read()) != meta["crc"]:
                    return None
        return manifest
    except (OSError, ValueError, KeyError):
        return None


def restore(ckpt_dir: str, like_state: Any) -> tuple[Any, int] | None:
    """The newest valid checkpoint in the structure of ``like_state``, its
    tensors on the devices of ``like_state``'s and wanting a gradient where
    those do, or None."""
    like = _flatten(like_state)
    for step in reversed(available_steps(ckpt_dir)):
        path = os.path.join(ckpt_dir, f"step_{step}")
        manifest = _verify(path)
        if manifest is None:
            continue
        leaves = []
        for key, leaf in like:
            meta = manifest["tensors"].get(key)
            shape = () if isinstance(leaf, int) else tuple(leaf.shape)
            if meta is None or tuple(meta["shape"]) != shape:
                break
            with open(os.path.join(path, meta["file"]), "rb") as f:
                arr = np.lib.format.read_array(f)
            leaves.append(_from_numpy(arr, meta["dtype"], leaf))
        else:
            it = iter(leaves)
            return tree_map(lambda _: next(it), like_state), step
    return None
