"""Multi-head Latent Attention (DeepSeek-V3) with a paged *latent* cache.

The KV cache stores only the compressed latent ``c_kv`` (kv_lora_rank) and
the shared RoPE key (qk_rope_head_dim) per token — 576 dims a token at
DeepSeek-V3's widths instead of n_heads × (d_k + d_v).  The latent pages
are small and uniform, and are read through the page table like the GQA
pool.

Decode uses the *absorbed* form: W_UK is folded into the query and W_UV
into the output, so attention runs in latent space and never expands
per-head keys/values for the context; its scan over the pages is plain
torch, as in the reference (which has no Pallas kernel for it either).

Training / prefill (:func:`apply_mla`) expands per-head K/V and calls
the flash kernels through their region ``attention._flash_dist`` at
head_dim ``qk_nope_head_dim + qk_rope_head_dim`` (192 at DeepSeek-V3's
widths), V zero-padded to it as the reference pads it.  A CPU tensor takes
the plain chunked version; a CUDA tensor the hand-written kernels at 192
(bf16 on the tensor cores, f32 on the CUDA cores) — there is no fallback.

DTensor inputs run the decode shard-local on each rank
(:func:`_mla_update_and_attend_dist`), as the GQA path does.
"""

from __future__ import annotations

import math

import torch

from repro_torch.distributed import logical
from repro_torch.distributed.logical import PartitionSpec as P
from repro_torch.models.attention import (_data_split, _flash_dist,
                                          _write_back, data_rank,
                                          paged_write_slots,
                                          rebase_page_table)
from repro_torch.models.attention_ops import NEG_INF
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (apply_norm, apply_rope, dense_init,
                                       init_norm)


def init_mla(gen: torch.Generator, cfg: ModelConfig, dtype):
    d, H = cfg.d_model, cfg.n_heads
    rq, rkv = cfg.q_lora_rank, cfg.kv_lora_rank
    nope, rope, vh = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    dev = gen.device
    return {
        "wq_a": dense_init(gen, d, rq, dtype),
        "q_norm": init_norm(rq, device=dev),
        "wq_b": dense_init(gen, rq, H * (nope + rope), dtype),
        "wkv_a": dense_init(gen, d, rkv + rope, dtype),
        "kv_norm": init_norm(rkv, device=dev),
        "wk_b": dense_init(gen, rkv, H * nope, dtype),
        "wv_b": dense_init(gen, rkv, H * vh, dtype),
        "wo": dense_init(gen, H * vh, d, dtype),
    }


def _latents(p, cfg: ModelConfig, x, positions):
    """Shared projection path: q heads + (c_kv, k_rope) latents."""
    B, S, _ = x.shape
    H = cfg.n_heads
    nope, rope = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    cq = apply_norm(p["q_norm"], x @ p["wq_a"], "rms", cfg.norm_eps)
    q = (cq @ p["wq_b"]).reshape(B, S, H, nope + rope)
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)

    kv = x @ p["wkv_a"]
    c_kv = apply_norm(p["kv_norm"], kv[..., :cfg.kv_lora_rank], "rms",
                      cfg.norm_eps)
    k_rope = kv[..., cfg.kv_lora_rank:][:, :, None, :]       # (B,S,1,rope)
    k_rope = apply_rope(k_rope, positions, cfg.rope_theta)[:, :, 0]
    return q_nope, q_rope, c_kv, k_rope


def apply_mla(p, cfg: ModelConfig, x, positions, *, q_chunk=512,
              kv_chunk=512):
    """Training / prefill: expand per-head K/V and run flash attention."""
    B, S, _ = x.shape
    H = cfg.n_heads
    nope, rope, vh = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    q_nope, q_rope, c_kv, k_rope = _latents(p, cfg, x, positions)
    k_nope = (c_kv @ p["wk_b"]).reshape(B, S, H, nope)
    v = (c_kv @ p["wv_b"]).reshape(B, S, H, vh)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(B, S, H, rope)],
                  dim=-1)
    # pad v to the qk head_dim so flash kernels see one head size; strip after
    v_p = logical.pad(v, (0, nope + rope - vh))
    out = _flash_dist(q, k, v_p, causal=True, window=0, q_chunk=q_chunk,
                      kv_chunk=kv_chunk)[..., :vh]
    return out.reshape(B, S, H * vh) @ p["wo"]


def _mla_update_and_attend(q_abs, q_rope, c_new, kr_new, ckv_pool,
                           krope_pool, page_table, lengths, *, scale: float):
    """Pool write + absorbed-latent page scan.

    The new token's latents go to the page of ``lengths - 1`` at the page
    offset of row 0 for the whole batch (decode steps are in lock-step, as
    on the GQA path), frames of ``-1`` clamped to 0; the pools are updated
    **in place** and returned.  Then an online softmax over the page-table
    slots, unmapped (``-1``) slots masked.  Returns (ctx (B, H, rkv) f32,
    ckv_pool, krope_pool).
    """
    B, H, rkv = q_abs.shape
    ps = ckv_pool.shape[1]
    slots = paged_write_slots(page_table, lengths, ps)
    ckv_pool.index_put_(slots, c_new.to(ckv_pool.dtype))
    krope_pool.index_put_(slots, kr_new.to(krope_pool.dtype))

    dev = q_abs.device
    m = torch.full((B, H), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, H), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, H, rkv), dtype=torch.float32, device=dev)
    offsets = torch.arange(ps, device=dev)
    for j in range(page_table.shape[1]):
        idx = page_table[:, j]
        safe = idx.clamp(min=0).long()
        c_pg = ckv_pool[safe].float()                         # (B, ps, rkv)
        r_pg = krope_pool[safe].float()                       # (B, ps, rope)
        s = (torch.einsum("bhr,bkr->bhk", q_abs, c_pg)
             + torch.einsum("bhr,bkr->bhk", q_rope, r_pg))
        s = s * scale
        valid = ((j * ps + offsets)[None, :] < lengths[:, None]) \
            & (idx >= 0)[:, None]
        s = torch.where(valid[:, None, :], s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1))
        pw = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + pw.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bhk,bkr->bhr", pw, c_pg)
        m = m_new
    ctx = acc / l[..., None].clamp_min(1e-30)                 # (B, H, rkv)
    return ctx, ckv_pool, krope_pool


def _mla_update_and_attend_dist(q_abs, q_rope, c_new, kr_new, ckv_pool,
                                krope_pool, page_table, lengths, *,
                                scale: float):
    """Shard-local variant: batch rows and latent pool pages co-sharded
    over the data axes, query heads split over ``'model'`` when it divides
    them (the latent pools have no head dim: they stay replicated over
    ``'model'``).  The same locality argument, conditions and DTensor
    handling as the GQA path's ``_paged_update_and_attend_dist``: plain
    tensors go to the body whole; DTensors always go through the region,
    every rank taking the whole batch and pools without a data split, and
    a pool laid out otherwise than the region gets the written pool copied
    back.  The local body makes its write slots from the rebased table.
    """
    if not logical.is_dtensor(q_abs):
        return _mla_update_and_attend(q_abs, q_rope, c_new, kr_new, ckv_pool,
                                      krope_pool, page_table, lengths,
                                      scale=scale)
    from torch.distributed.tensor import DTensor
    mesh = q_abs.device_mesh
    d, dsize = _data_split(mesh, q_abs.shape[0], ckv_pool.shape[0])
    msize = logical.mesh_shape(mesh).get("model", 1)
    h = "model" if ("model" in mesh.mesh_dim_names
                    and q_abs.shape[1] % msize == 0) else None
    head = logical.placements(mesh, P(d, h))
    rows = logical.placements(mesh, P(d))
    qa, qr, cn, kn, cp, kp, pt, ln = [
        x.redistribute(mesh, pl).to_local() for x, pl in zip(
            (q_abs, q_rope, c_new, kr_new, ckv_pool, krope_pool, page_table,
             lengths), (head, head) + (rows,) * 6)]
    pt = rebase_page_table(pt, data_rank(mesh, d) if d else 0,
                           ckv_pool.shape[0] // dsize)
    ctx, cp, kp = _mla_update_and_attend(qa, qr, cn, kn, cp, kp, pt, ln,
                                         scale=scale)
    _write_back(((ckv_pool, cp), (krope_pool, kp)), mesh, rows)
    return (DTensor.from_local(ctx, mesh, head, run_check=False),
            DTensor.from_local(cp, mesh, rows, run_check=False),
            DTensor.from_local(kp, mesh, rows, run_check=False))


def apply_mla_decode_paged(p, cfg: ModelConfig, x, ckv_pool, krope_pool,
                           page_table, lengths):
    """Absorbed-form decode through the paged latent cache.

    ckv_pool:   (P, page_tokens, kv_lora_rank)
    krope_pool: (P, page_tokens, qk_rope_head_dim)
    Both are updated in place.  Returns (out, ckv_pool, krope_pool).
    """
    B = x.shape[0]
    H = cfg.n_heads
    nope, rope, vh = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    rkv = cfg.kv_lora_rank
    pos = lengths - 1
    q_nope, q_rope, c_kv, k_rope = _latents(p, cfg, x, pos[:, None])
    q_nope, q_rope = q_nope[:, 0], q_rope[:, 0]               # (B,H,*)
    c_new, kr_new = c_kv[:, 0], k_rope[:, 0]

    # absorb W_UK into q:  q_abs (B,H,rkv)
    wk_b = p["wk_b"].reshape(rkv, H, nope)
    q_abs = torch.einsum("bhn,rhn->bhr", q_nope.float(), wk_b.float())
    scale = 1.0 / math.sqrt(nope + rope)
    ctx, ckv_pool, krope_pool = _mla_update_and_attend_dist(
        q_abs, q_rope.float(), c_new, kr_new, ckv_pool, krope_pool,
        page_table, lengths, scale=scale)
    wv_b = p["wv_b"].reshape(rkv, H, vh)
    out = torch.einsum("bhr,rhv->bhv", ctx, wv_b.float())
    out = out.reshape(B, H * vh).to(x.dtype) @ p["wo"]
    return out[:, None, :], ckv_pool, krope_pool
