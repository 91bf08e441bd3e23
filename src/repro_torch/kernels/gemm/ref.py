"""Plain PyTorch version of the tiled GEMM kernel.

Same contract as ``repro/kernels/gemm/ref.py::gemm_ref``: ``a @ b`` with
f32 products and sums, cast to a's dtype.
"""
from __future__ import annotations

import torch


def gemm_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (M, K) @ b (K, N) → (M, N) in a's dtype."""
    return (a.float() @ b.float()).to(a.dtype)
