"""Plain softmax attention, the ``--flash off`` path.

Counterpart of ``tpudist.parallel.ring_attention.attention``; the ring
(sequence-parallel) form comes later. The op order is the reference's:
QKᵀ in the input dtype, then f32, then ``/√d``, then an f32 softmax, then
the probabilities cast to V's dtype for the second product.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = False) -> torch.Tensor:
    """Plain softmax attention. Shapes [B, T, H, D]; fp32 softmax."""
    d = q.shape[-1]
    s = torch.einsum("bqhd,bkhd->bhqk", q, k).float()
    s = s / torch.tensor(float(d), dtype=torch.float32).sqrt()
    if causal:
        tq, tk = s.shape[-2], s.shape[-1]
        mask = torch.ones(tq, tk, dtype=torch.bool,
                          device=s.device).tril(tk - tq)
        s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v)
