"""Plain PyTorch version of the grouped (per-expert) GEMM kernel.

Same contract as ``repro/kernels/grouped_gemm/ref.py::grouped_gemm_ref``:
``out[e] = a[e] @ w[e]`` with f32 products and sums, cast to a's dtype.
"""
from __future__ import annotations

import torch


def grouped_gemm_ref(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a (E, M, K) @ w (E, K, N) → (E, M, N) in a's dtype."""
    return torch.einsum("emk,ekn->emn", a.float(), w.float()).to(a.dtype)
