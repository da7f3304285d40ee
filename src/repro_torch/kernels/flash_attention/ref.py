"""Plain PyTorch version of blocked flash attention (materializing softmax)
and of its backward kernels.

Same function as the CUDA kernel and as the reference's
``flash_attention_ref``, in the reference's kernel layout: builds the whole
``(Sq, Sk)`` score matrix per head, masks it with ``-1e30`` and runs one
softmax — f32 arithmetic, result in q's dtype.  O(Sq·Sk) memory: a test
oracle and the yardstick the kernel is held to on the card.  Sq may differ
from Sk (cross-attention); the masks then compare the same row and column
indices as at Sq = Sk, as the kernels' do.
"""

from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def _probs(q, k, causal: bool, window: int):
    """Softmax of the masked scores, f32: (B, KVH, G, Sq, Sk)."""
    B, H, Sq, D = q.shape
    KVH, Sk = k.shape[1], k.shape[2]
    qh = q.reshape(B, KVH, H // KVH, Sq, D).float()
    s = torch.einsum("bhgqd,bhkd->bhgqk", qh, k.float()) / math.sqrt(D)
    q_pos = torch.arange(Sq, device=q.device)[:, None]
    k_pos = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= q_pos >= k_pos
    if window > 0:
        mask &= (q_pos - k_pos) < window
    s = torch.where(mask[None, None, None], s, torch.full_like(s, NEG_INF))
    return torch.softmax(s, dim=-1)


def flash_attention_ref(q, k, v, *, causal: bool = True, window: int = 0):
    """q: (B, H, Sq, D); k, v: (B, KVH, Sk, D) -> (B, H, Sq, D)."""
    B, H, Sq, D = q.shape
    p = _probs(q, k, causal, window)
    out = torch.einsum("bhgqk,bhkd->bhgqd", p, v.float())
    return out.reshape(B, H, Sq, D).to(q.dtype)


def flash_attention_bwd_ref(q, k, v, o, do, *, causal: bool = True,
                            window: int = 0):
    """Gradients of ``flash_attention_ref`` as the backward kernels form
    them: the row term ``rowsum(do * o)`` is taken from the given forward
    output ``o`` (in its own dtype), not from the unrounded one.  q, o, do:
    (B, H, Sq, D); k, v: (B, KVH, Sk, D) -> dq, dk, dv in the inputs'
    dtypes, f32 arithmetic."""
    B, H, Sq, D = q.shape
    KVH = k.shape[1]
    G = H // KVH

    def heads(t):
        return t.reshape(B, KVH, G, Sq, D).float()

    qh, oh, doh = heads(q), heads(o), heads(do)
    p = _probs(q, k, causal, window)
    dp = torch.einsum("bhgqd,bhkd->bhgqk", doh, v.float())
    ds = p * (dp - (doh * oh).sum(-1, keepdim=True)) / math.sqrt(D)
    del dp
    dq = torch.einsum("bhgqk,bhkd->bhgqd", ds, k.float())
    dk = torch.einsum("bhgqk,bhgqd->bhkd", ds, qh)
    dv = torch.einsum("bhgqk,bhgqd->bhkd", p, doh)
    return (dq.reshape(B, H, Sq, D).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))
