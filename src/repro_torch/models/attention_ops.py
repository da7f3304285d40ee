"""Attention in plain PyTorch: the oracles and plain versions of the port.

All GQA-aware, fp32 accumulation:

* :func:`mha_reference` — materializes the score matrix; a test oracle.
* :func:`paged_attention_scan` — decode attention that reads K/V through a
  **page table**, one page per step with an online softmax, never
  materializing the (B, S) context.  It is the reference's
  ``paged_attention_xla`` and repeats the arithmetic of the CUDA kernel
  step for step; the model path does not call it (it calls
  ``kernels.paged_attention.ops.paged_attention``).
* :func:`flash_attention_xla` — training / prefill attention with an
  online softmax over KV chunks: the reference's chunked version, and the
  plain version ``kernels.flash_attention.ops.flash_attention`` takes for a
  CPU tensor (autograd differentiates it there).
* :func:`ring_buffer_attention` — decode attention over a sliding-window
  ring buffer (no kernel in the reference either).
"""

from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def _gqa_split(q, n_kv: int):
    """(B, S, H, D) -> (B, S, KVH, G, D)."""
    B, S, H, D = q.shape
    return q.reshape(B, S, n_kv, H // n_kv, D)


def mha_reference(q, k, v, *, causal: bool = True, window: int = 0,
                  q_offset: int = 0, lengths=None):
    """Materializing attention oracle.

    q: (B, Sq, H, D); k, v: (B, Sk, KVH, D); q_offset: absolute position of
    q[0] (for decode, q_offset = context_len - Sq).  lengths: (B,) valid
    prefix of k/v.
    """
    B, Sq, H, D = q.shape
    KVH = k.shape[2]
    Sk = k.shape[1]
    qh = _gqa_split(q, KVH).float()
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qh, k.float()) / math.sqrt(D)
    q_pos = q_offset + torch.arange(Sq, device=q.device)
    k_pos = torch.arange(Sk, device=q.device)
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= q_pos[:, None] >= k_pos[None, :]
    if window > 0:
        mask &= (q_pos[:, None] - k_pos[None, :]) < window
    mask = mask[None, None, None]
    if lengths is not None:
        mask = mask & (k_pos[None, :] < lengths[:, None])[:, None, None, None]
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v.float())
    return out.reshape(B, Sq, H, D).to(q.dtype)


def _pad_to(x, axis: int, multiple: int):
    n = x.shape[axis]
    pad = (-n) % multiple
    if pad == 0:
        return x, n
    widths = [0, 0] * (x.dim() - 1 - axis) + [0, pad]
    return torch.nn.functional.pad(x, widths), n


def flash_attention_xla(q, k, v, *, causal: bool = True, window: int = 0,
                        q_chunk: int = 512, kv_chunk: int = 512,
                        q_offset: int = 0):
    """Chunked flash attention: a loop over KV chunks with an online
    softmax, all queries at once (as in the reference, ``q_chunk`` is
    accepted and unused).

    q: (B, Sq, H, D); k, v: (B, Sk, KVH, D); ``q_offset`` is the absolute
    position of q[0].  GQA expands K/V to the full head count one chunk at a
    time.  Peak live memory per chunk: one (B, H, Sq, kv_chunk) f32 tile.
    """
    B, Sq, H, D = q.shape
    KVH = k.shape[2]
    G = H // KVH
    scale = 1.0 / math.sqrt(D)
    kv_chunk = min(kv_chunk, k.shape[1])
    kp, Sk0 = _pad_to(k, 1, kv_chunk)
    vp, _ = _pad_to(v, 1, kv_chunk)
    nk = kp.shape[1] // kv_chunk
    q_pos = q_offset + torch.arange(Sq, device=q.device)
    qf = q.float() * scale
    m = torch.full((B, H, Sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, H, Sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, H, Sq, D), dtype=torch.float32, device=q.device)
    for j in range(nk):
        k_blk = kp[:, j * kv_chunk:(j + 1) * kv_chunk]      # (B, Ck, KVH, D)
        v_blk = vp[:, j * kv_chunk:(j + 1) * kv_chunk]
        if G > 1:
            k_blk = k_blk.repeat_interleave(G, dim=2)
            v_blk = v_blk.repeat_interleave(G, dim=2)
        s = torch.einsum("bqhd,bkhd->bhqk", qf, k_blk.float())
        k_p = j * kv_chunk + torch.arange(kv_chunk, device=q.device)
        mask = (k_p < Sk0)[None, :]
        if causal:
            mask = mask & (q_pos[:, None] >= k_p[None, :])
        if window > 0:
            mask = mask & ((q_pos[:, None] - k_p[None, :]) < window)
        s = torch.where(mask[None, None], s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        pv = torch.einsum("bhqk,bkhd->bhqd", p, v_blk.float())
        acc = acc * corr[..., None] + pv
        m = m_new
    out = acc / l[..., None].clamp(min=1e-30)                # (B, H, Sq, D)
    return out.transpose(1, 2).to(q.dtype)


def paged_attention_scan(q, k_pool, v_pool, page_table, lengths, *,
                         window: int = 0):
    """Decode attention through a KV page table (one token per sequence).

    q:          (B, H, D)
    k/v_pool:   (P, page_tokens, KVH, D) — the shared frame pool
    page_table: (B, max_pages) int, -1 = unmapped (clamped to frame 0 and
                masked; the serving engine resolves residency before the
                step, so the step only ever sees resident frames)
    lengths:    (B,) context length per sequence
    """
    B, H, D = q.shape
    P, ps, KVH, _ = k_pool.shape
    G = H // KVH
    scale = 1.0 / math.sqrt(D)
    max_pages = page_table.shape[1]
    qf = q.reshape(B, KVH, G, D).float() * scale
    lens = lengths.long()[:, None]
    m = torch.full((B, KVH, G), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, KVH, G), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, KVH, G, D), dtype=torch.float32, device=q.device)
    for j in range(max_pages):
        idx = page_table[:, j].long()                 # (B,)
        safe = idx.clamp(min=0)
        k_pg = k_pool[safe].float()                   # (B, ps, KVH, D)
        v_pg = v_pool[safe].float()
        s = torch.einsum("bhgd,bkhd->bhgk", qf, k_pg)  # (B, KVH, G, ps)
        pos = j * ps + torch.arange(ps, device=q.device)
        valid = (pos[None, :] < lens) & (idx >= 0)[:, None]
        if window > 0:
            valid = valid & ((lens - 1 - pos[None, :]) < window)
        s = torch.where(valid[:, None, None, :], s,
                        torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.max(dim=-1).values)
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        pv = torch.einsum("bhgk,bkhd->bhgd", p, v_pg)
        acc = acc * corr[..., None] + pv
        m = m_new
    out = acc / l[..., None].clamp(min=1e-30)
    return out.reshape(B, H, D).to(q.dtype)


# the reference's name for the same function
paged_attention_xla = paged_attention_scan


def ring_buffer_attention(q, k_ring, v_ring, cur_len, window: int):
    """Decode attention over a sliding-window ring buffer.

    q: (B, H, D); k/v_ring: (B, W, KVH, D); cur_len: (B,) tokens seen so
    far (ring holds the last min(cur_len, W) of them, written mod W).
    """
    B, H, D = q.shape
    W = k_ring.shape[1]
    KVH = k_ring.shape[2]
    G = H // KVH
    scale = 1.0 / math.sqrt(D)
    qf = q.reshape(B, KVH, G, D).float() * scale
    s = torch.einsum("bhgd,bkhd->bhgk", qf, k_ring.float())
    slot = torch.arange(W, device=q.device)[None, :]
    n_valid = cur_len.clamp(max=W)[:, None]
    # slots 0..n_valid-1 are in use; once cur_len >= W the ring has wrapped
    # and all W slots are valid (n_valid == W then)
    valid = slot < n_valid
    s = torch.where(valid[:, None, None, :], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgk,bkhd->bhgd", p, v_ring.float())
    return out.reshape(B, H, D).to(q.dtype)
