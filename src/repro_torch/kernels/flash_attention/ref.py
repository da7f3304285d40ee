"""Plain PyTorch version of blocked flash attention (materializing softmax)
and of its backward kernels.

Same function as the CUDA kernel and as the reference's
``flash_attention_ref``, in the reference's kernel layout: builds the whole
``(Sq, Sk)`` score matrix per head, masks it with ``-1e30`` and runs one
softmax — f32 arithmetic, result in q's dtype.  O(Sq·Sk) memory: a test
oracle and the yardstick the kernel is held to on the card.  Sq may differ
from Sk (cross-attention); the masks then compare the same row and column
indices as at Sq = Sk, as the kernels' do.  ``q_offset`` places row i of q
at absolute position ``q_offset + i`` (a rank's rows of a sequence split).

Two more plain versions model, step by step, the arithmetic of a kernel
that the results alone do not show; nothing on the path calls them, the
CPU tests hold them against the reference: ``flash_attention_split_ref``
(the decode kernel's split of the keys into N shares and its combine in
rank order) and ``flash_attention_dkdv_by_head_ref`` (the f32 backward's
dK, dV as one term a query head, added in head order).
"""

from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def _mask(Sq: int, Sk: int, causal: bool, window: int, q_offset: int, dev):
    q_pos = q_offset + torch.arange(Sq, device=dev)[:, None]
    k_pos = torch.arange(Sk, device=dev)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=dev)
    if causal:
        mask &= q_pos >= k_pos
    if window > 0:
        mask &= (q_pos - k_pos) < window
    return mask


def _probs(q, k, causal: bool, window: int, q_offset: int = 0):
    """Softmax of the masked scores, f32: (B, KVH, G, Sq, Sk)."""
    B, H, Sq, D = q.shape
    KVH, Sk = k.shape[1], k.shape[2]
    qh = q.reshape(B, KVH, H // KVH, Sq, D).float()
    s = torch.einsum("bhgqd,bhkd->bhgqk", qh, k.float()) / math.sqrt(D)
    mask = _mask(Sq, Sk, causal, window, q_offset, q.device)
    s = torch.where(mask[None, None, None], s, torch.full_like(s, NEG_INF))
    return torch.softmax(s, dim=-1)


def flash_attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                        q_offset: int = 0):
    """q: (B, H, Sq, D); k, v: (B, KVH, Sk, D) -> (B, H, Sq, D)."""
    B, H, Sq, D = q.shape
    p = _probs(q, k, causal, window, q_offset)
    out = torch.einsum("bhgqk,bhkd->bhgqd", p, v.float())
    return out.reshape(B, H, Sq, D).to(q.dtype)


def flash_attention_bwd_ref(q, k, v, o, do, *, causal: bool = True,
                            window: int = 0, q_offset: int = 0):
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
    p = _probs(q, k, causal, window, q_offset)
    dp = torch.einsum("bhgqd,bhkd->bhgqk", doh, v.float())
    ds = p * (dp - (doh * oh).sum(-1, keepdim=True)) / math.sqrt(D)
    del dp
    dq = torch.einsum("bhgqk,bhkd->bhgqd", ds, k.float())
    dk = torch.einsum("bhgqk,bhgqd->bhkd", ds, qh)
    dv = torch.einsum("bhgqk,bhgqd->bhkd", p, doh)
    return (dq.reshape(B, H, Sq, D).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def split_shares(Sq: int, Sk: int, causal: bool, window: int, q_offset: int,
                 n_splits: int, tile: int) -> list:
    """The key ranges ``[lo, hi)`` of the ``n_splits`` blocks of a decode
    cluster (``csrc/flash_decode.cu``): the keys ``[first, end)`` that rows
    at ``q_offset .. q_offset + Sq - 1`` see, in ``tile``-key tiles from the
    tile that holds ``first``, ``ceil(tiles / N)`` tiles a block, rank
    order; a share past the last tile is empty."""
    end = min(Sk, q_offset + Sq) if causal else Sk
    first = max(0, q_offset - window + 1) if window > 0 else 0
    start = first // tile * tile
    tiles = max(0, -(-(end - start) // tile))
    per = -(-tiles // n_splits)
    shares = []
    for r in range(n_splits):
        lo = min(r * per, tiles)
        hi = min(lo + per, tiles)
        shares.append((min(Sk, start + lo * tile), min(Sk, start + hi * tile)))
    return shares


def flash_attention_split_ref(q, k, v, *, causal: bool = True,
                              window: int = 0, q_offset: int = 0,
                              n_splits: int = 1, tile: int = 64):
    """The decode kernel's arithmetic in plain f32: each share of
    :func:`split_shares` (over the keys all Sq rows see; a kernel block
    whose rows are a part of them splits its own rows' keys) gives a
    partial ``(m_r, l_r, acc_r)`` of its keys
    (masked scores dropped: ``m_r = -1e30``, ``l_r = 0``, ``acc_r = 0``
    where a share sees none), and the partials are combined in rank order,
    ``M = max m_r``, ``l = sum l_r exp(m_r - M)``, ``o = sum acc_r
    exp(m_r - M) / max(l, 1e-30)``, ``lse = M + log l``.  q: (B, H, Sq, D);
    k, v: (B, KVH, Sk, D) -> o (B, H, Sq, D) in q's dtype, lse (B, H, Sq)
    f32."""
    B, H, Sq, D = q.shape
    KVH, Sk = k.shape[1], k.shape[2]
    qh = q.reshape(B, KVH, H // KVH, Sq, D).float()
    s = torch.einsum("bhgqd,bhkd->bhgqk", qh, k.float()) / math.sqrt(D)
    mask = _mask(Sq, Sk, causal, window, q_offset, q.device)
    parts = []
    for lo, hi in split_shares(Sq, Sk, causal, window, q_offset, n_splits,
                               tile):
        ok = mask[:, lo:hi]
        sr = torch.where(ok, s[..., lo:hi], torch.full_like(s[..., lo:hi],
                                                             NEG_INF))
        m_r = sr.amax(-1) if hi > lo else torch.full(
            s.shape[:-1], NEG_INF, device=q.device)
        p = torch.where(ok, torch.exp(sr - m_r[..., None]),
                        torch.zeros_like(sr))
        parts.append((m_r, p.sum(-1), torch.einsum(
            "bhgqk,bhkd->bhgqd", p, v[:, :, lo:hi].float())))
    M = torch.stack([m for m, _, _ in parts]).amax(0)
    l = torch.zeros_like(M)
    acc = torch.zeros(M.shape + (D,), device=q.device)
    for m_r, l_r, acc_r in parts:           # rank order
        f = torch.exp(m_r - M)
        l = l + l_r * f
        acc = acc + acc_r * f[..., None]
    o = acc / l.clamp_min(1e-30)[..., None]
    lse = M + torch.log(l)
    return (o.reshape(B, H, Sq, D).to(q.dtype), lse.reshape(B, H, Sq))


def flash_attention_dkdv_by_head_ref(q, k, v, o, do, *, causal: bool = True,
                                     window: int = 0, q_offset: int = 0):
    """dK, dV as the f32 backward forms them: each query head's terms
    ``dS_h^T q_h`` and ``P_h^T dO_h`` apart (``flash_bwd_dkdv_kernel``, one
    block a head), then added in head order ``g = 0 .. G - 1``
    (``flash_bwd_dkdv_sum_kernel``).  Layouts and the row term as
    :func:`flash_attention_bwd_ref`; returns dk, dv (B, KVH, Sk, D) in
    k's dtype."""
    B, H, Sq, D = q.shape
    KVH = k.shape[1]
    G = H // KVH
    p = _probs(q, k, causal, window, q_offset)      # (B, KVH, G, Sq, Sk)

    def heads(t):
        return t.reshape(B, KVH, G, Sq, D).float()

    qh, oh, doh = heads(q), heads(o), heads(do)
    dp = torch.einsum("bhgqd,bhkd->bhgqk", doh, v.float())
    ds = p * (dp - (doh * oh).sum(-1, keepdim=True)) / math.sqrt(D)
    dk_h = torch.einsum("bhgqk,bhgqd->bhgkd", ds, qh)
    dv_h = torch.einsum("bhgqk,bhgqd->bhgkd", p, doh)
    dk, dv = dk_h[:, :, 0], dv_h[:, :, 0]
    for g in range(1, G):
        dk = dk + dk_h[:, :, g]
        dv = dv + dv_h[:, :, g]
    return dk.to(k.dtype), dv.to(v.dtype)
