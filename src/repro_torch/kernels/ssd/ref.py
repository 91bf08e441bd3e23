"""Plain PyTorch version of the SSD intra-chunk kernel.

Same arithmetic as ``repro/kernels/ssd/ref.py::ssd_intra_chunk_ref``, in
f32, with the TPU contract's flat G split into (chunk rows, heads) so B and
C can broadcast over heads.
"""
from __future__ import annotations

import torch

F32 = torch.float32


def ssd_intra_chunk_ref(x, cs, B, C):
    """x (G,H,Q,P), cs (G,H,Q), B/C (G,H,Q,N) → y (G,H,Q,P), states
    (G,H,N,P)."""
    x, cs, B, C = x.to(F32), cs.to(F32), B.to(F32), C.to(F32)
    Q = x.shape[2]
    seg = cs[..., :, None] - cs[..., None, :]          # cs[t] - cs[s]
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    # masked before the exp: above the diagonal cs[t] - cs[s] > 0 grows with
    # the chunk and overflows exp, and a select after it would still send
    # 0 · inf = NaN into the gradient (the backward differentiates this)
    L = torch.exp(torch.where(tri, seg, torch.tensor(float("-inf"),
                                                     device=x.device)))
    att = torch.einsum("ghtn,ghsn->ghts", C, B) * L
    y = torch.einsum("ghts,ghsp->ghtp", att, x)
    decay_end = torch.exp(cs[..., -1:] - cs)           # (G,H,Q)
    st = torch.einsum("ghsn,ghsp->ghnp", B * decay_end[..., None], x)
    return y, st
