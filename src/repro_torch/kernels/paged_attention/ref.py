"""Plain PyTorch version of paged decode attention (materializing gather).

Same function as the CUDA kernel and as the reference's
``paged_attention_ref``, in the model layout: gathers every sequence's
whole context through the page table and runs one masked softmax —
O(B·S) memory, fp32 arithmetic, result in q's dtype.
"""

from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def paged_attention_ref(q, k_pool, v_pool, page_table, lengths, *,
                        window: int = 0):
    """q: (B, H, D); k/v_pool: (P, ps, KVH, D); page_table: (B, NP);
    lengths: (B,).  Returns (B, H, D)."""
    B, H, D = q.shape
    P, ps, KVH, _ = k_pool.shape
    G = H // KVH
    NP = page_table.shape[1]
    safe = page_table.clamp(min=0).long()                    # (B, NP)
    k = k_pool[safe].reshape(B, NP * ps, KVH, D).float()     # (B, S, KVH, D)
    v = v_pool[safe].reshape(B, NP * ps, KVH, D).float()
    qf = q.reshape(B, KVH, G, D).float()
    s = torch.einsum("bhgd,bkhd->bhgk", qf, k) / math.sqrt(D)
    pos = torch.arange(NP * ps, device=q.device)
    lens = lengths.long()[:, None]
    valid = pos[None, :] < lens
    valid = valid & (page_table >= 0).repeat_interleave(ps, dim=1)
    if window > 0:
        valid = valid & ((lens - 1 - pos[None, :]) < window)
    s = torch.where(valid[:, None, None, :], s,
                    torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgk,bkhd->bhgd", p, v)
    return out.reshape(B, H, D).to(q.dtype)
