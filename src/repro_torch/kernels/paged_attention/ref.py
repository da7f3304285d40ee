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


def _combine(parts):
    """(m, l, acc) partials combined in list order, each rescaled by
    exp(m_i - M): the kernel's warp and cluster combines."""
    M = parts[0][0]
    for m, _, _ in parts[1:]:
        M = torch.maximum(M, m)
    lsum = torch.zeros_like(M)
    acc = torch.zeros_like(parts[0][2])
    for m, l, a in parts:
        f = torch.exp(m - M)
        lsum = lsum + l * f
        acc = acc + a * f[..., None]
    return M, lsum, acc


def paged_attention_split_ref(q, k_pool, v_pool, page_table, lengths, *,
                              window: int = 0, n_splits: int = 1,
                              tile_rows: int = 64, warps: int = 8):
    """The CUDA kernel's algorithm in plain torch, step by step: the visible
    range ``[first, end)`` of each sequence, cut into ``tile_rows`` tiles
    aligned to the tile grid, is shared out in ``n_splits`` equal runs of
    tiles; in each split, consumer warp ``w`` takes rows ``[w * R, (w + 1) *
    R)`` of every tile (``R = tile_rows / warps``) and keeps an online
    softmax ``(m, l, acc)`` over them, masked rows skipped; the warps'
    partials are combined in warp order, then the splits' in split order.
    A row with no valid position gets the mean of the V rows of all
    ``NP * ps`` positions, an unmapped page read as frame 0."""
    B, H, D = q.shape
    P, ps, KVH, _ = k_pool.shape
    G = H // KVH
    NP = page_table.shape[1]
    cap = NP * ps
    R = tile_rows // warps
    qf = q.reshape(B, KVH, G, D).float() / math.sqrt(D)
    out = torch.empty((B, KVH, G, D), dtype=torch.float32, device=q.device)
    pos = torch.arange(cap, device=q.device)
    for b in range(B):
        entries = page_table[b].long().repeat_interleave(ps)      # (cap,)
        rows = entries.clamp(min=0) * ps + pos % ps
        kb = k_pool.reshape(P * ps, KVH, D)[rows].float()   # (cap, KVH, D)
        vb = v_pool.reshape(P * ps, KVH, D)[rows].float()
        length = int(lengths[b])
        end = min(length, cap)
        first = length - window if window > 0 and length - window > 0 else 0
        valid = (pos >= first) & (pos < end) & (entries >= 0)
        t_start = first // tile_rows * tile_rows
        n_tiles = -(-(end - t_start) // tile_rows) if end > t_start else 0
        per = -(-n_tiles // n_splits)
        splits = []
        for r in range(n_splits):
            lo = min(r * per, n_tiles)
            hi = min(lo + per, n_tiles)
            warp_parts = []
            for w in range(warps):
                m = torch.full((KVH, G), NEG_INF, device=q.device)
                lsum = torch.zeros((KVH, G), device=q.device)
                acc = torch.zeros((KVH, G, D), device=q.device)
                for i in range(lo, hi):
                    t0 = t_start + i * tile_rows + w * R
                    sel = torch.arange(t0, max(t0, min(t0 + R, cap)),
                                       device=q.device)
                    sel = sel[valid[sel]]
                    if sel.numel() == 0:
                        continue
                    s = torch.einsum("hgd,khd->hgk", qf[b], kb[sel])
                    m_new = torch.maximum(m, s.amax(-1))
                    p = torch.exp(s - m_new[..., None])
                    corr = torch.exp(m - m_new)
                    lsum = lsum * corr + p.sum(-1)
                    acc = acc * corr[..., None] + torch.einsum(
                        "hgk,khd->hgd", p, vb[sel])
                    m = m_new
                warp_parts.append((m, lsum, acc))
            splits.append(_combine(warp_parts))
        _, lsum, acc = _combine(splits)
        res = acc / lsum.clamp(min=1e-30)[..., None]
        empty = lsum == 0
        if bool(empty.any()):
            mean = vb.mean(0)                                     # (KVH, D)
            res = torch.where(empty[..., None],
                              mean[:, None, :].expand_as(res), res)
        out[b] = res
    return out.reshape(B, H, D).to(q.dtype)
