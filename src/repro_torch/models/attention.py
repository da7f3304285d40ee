"""GQA attention layer: projections + RoPE + qk-norm + SWA + paged decode.

Decode only so far; training / prefill attention (``apply_attention``) is
not ported yet.  The paged decode path calls the hand-written kernel
through ``kernels.paged_attention.ops.paged_attention``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.paged_attention.ops import paged_attention
from repro_torch.models.attention_ops import ring_buffer_attention
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (apply_rope, constrain, dense_init,
                                       rms_head_norm, rope_tables)


def init_attention(gen: torch.Generator, cfg: ModelConfig, dtype):
    d, H, KVH, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dev = gen.device
    p = {
        "wq": dense_init(gen, d, H * hd, dtype),
        "wk": dense_init(gen, d, KVH * hd, dtype),
        "wv": dense_init(gen, d, KVH * hd, dtype),
        "wo": dense_init(gen, H * hd, d, dtype),
    }
    if cfg.attn_bias:
        p["bq"] = torch.zeros((H * hd,), dtype=dtype, device=dev)
        p["bk"] = torch.zeros((KVH * hd,), dtype=dtype, device=dev)
        p["bv"] = torch.zeros((KVH * hd,), dtype=dtype, device=dev)
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((hd,), dtype=torch.float32, device=dev)
        p["k_norm"] = torch.ones((hd,), dtype=torch.float32, device=dev)
    return p


def _qkv(p, cfg: ModelConfig, x, positions, rope=None):
    """``rope``: precomputed ``rope_tables`` for ``positions`` (made here
    when absent)."""
    B, S, _ = x.shape
    H, KVH, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(B, S, H, hd)
    k = k.reshape(B, S, KVH, hd)
    v = v.reshape(B, S, KVH, hd)
    if cfg.qk_norm:
        q = rms_head_norm(p["q_norm"], q, cfg.norm_eps)
        k = rms_head_norm(p["k_norm"], k, cfg.norm_eps)
    if rope is None:
        rope = rope_tables(positions, hd, cfg.rope_theta)
    q = apply_rope(q, positions, cfg.rope_theta, rope)
    k = apply_rope(k, positions, cfg.rope_theta, rope)
    q = constrain(q, "batch", "q_seq", "heads", "head_dim")
    k = constrain(k, "batch", "kv_seq", "kv_heads", "head_dim")
    v = constrain(v, "batch", "kv_seq", "kv_heads", "head_dim")
    return q, k, v


def paged_write_slots(page_table, lengths, ps: int):
    """(frame, offset) index tensors, each (B,), of the pool rows that take
    the new token's K/V.  As in the reference, the whole batch writes at
    the page offset of row 0 (``offset[0]``): decode steps are in lockstep.
    The same for every layer of a step, so ``decode_step`` makes them once.
    """
    pos = lengths - 1
    page_slot = torch.div(pos, ps, rounding_mode="floor")
    offset = pos - page_slot * ps
    frame = torch.gather(page_table, 1, page_slot[:, None].long())[:, 0]
    frame = frame.clamp(min=0).long()
    return frame, offset[:1].long().expand(frame.shape[0])


def _paged_update_and_attend(q1, k1, v1, k_pool, v_pool, page_table,
                             lengths, window: int, slots=None):
    """Write the new token's K/V into its page, then attend.

    The pools are updated **in place** (and returned).  ``slots``:
    precomputed :func:`paged_write_slots` (made here when absent).
    """
    if slots is None:
        slots = paged_write_slots(page_table, lengths, k_pool.shape[1])
    k_pool.index_put_(slots, k1)
    v_pool.index_put_(slots, v1)
    out = paged_attention(q1, k_pool, v_pool, page_table, lengths,
                          window=window)
    return out, k_pool, v_pool


def apply_attention_decode_paged(p, cfg: ModelConfig, x, k_pool, v_pool,
                                 page_table, lengths, rope=None, slots=None):
    """One-token decode through the paged KV pool.

    x: (B, 1, d).  ``lengths`` counts tokens *including* the current one.
    The new token's K/V is written into its page (uniform offset across the
    batch — decode steps are in lockstep), then attention reads the whole
    context through the page table.  ``k_pool`` / ``v_pool`` are updated in
    place.  ``rope`` / ``slots`` are the step's precomputed ``rope_tables``
    and ``paged_write_slots`` (both made here when absent).
    Returns (out, k_pool, v_pool).
    """
    B = x.shape[0]
    pos = lengths - 1                                     # (B,) current index
    q, k, v = _qkv(p, cfg, x, pos[:, None], rope)
    q1, k1, v1 = q[:, 0].contiguous(), k[:, 0], v[:, 0]
    out, k_pool, v_pool = _paged_update_and_attend(
        q1, k1, v1, k_pool, v_pool, page_table, lengths, cfg.sliding_window,
        slots)
    out = out.reshape(B, cfg.n_heads * cfg.head_dim) @ p["wo"]
    return out[:, None, :], k_pool, v_pool


def apply_attention_decode_ring(p, cfg: ModelConfig, x, k_ring, v_ring,
                                lengths, rope=None):
    """One-token decode over a sliding-window ring buffer (SWA archs).

    The ring IS the resident set: everything older than the window has
    been dropped.  The whole batch writes at the slot of row 0
    (``pos[0] % W``, lockstep); ``k_ring`` / ``v_ring`` are updated in
    place.  Returns (out, k_ring, v_ring).
    """
    B = x.shape[0]
    W = k_ring.shape[1]
    pos = lengths - 1
    q, k, v = _qkv(p, cfg, x, pos[:, None], rope)
    q1, k1, v1 = q[:, 0], k[:, 0], v[:, 0]
    slot = torch.remainder(pos[:1], W).long()             # (1,)
    k_ring.index_copy_(1, slot, k1[:, None])
    v_ring.index_copy_(1, slot, v1[:, None])
    out = ring_buffer_attention(q1, k_ring, v_ring, lengths,
                                cfg.sliding_window)
    out = out.reshape(B, cfg.n_heads * cfg.head_dim) @ p["wo"]
    return out[:, None, :], k_ring, v_ring
