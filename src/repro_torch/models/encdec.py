"""Whisper-style encoder-decoder backbone.

The audio frontend (two convolutions over log-mel) is a stub, as in the
reference: the encoder consumes precomputed frame embeddings (B, T_src, d)
directly.  Decoder self-attention KV is paged; cross-attention KV is
computed once from the encoder output and *pinned* — the encoder-decoder
form of the thesis' pinned-vs-paged split.

Parameters keep the reference's stacked layout (``enc_layers`` and
``dec_layers``, every leaf ``(L, ...)``); Python loops over that axis take
the place of the reference's scans, and ``remat=True`` wraps each layer in
``torch.utils.checkpoint`` where the reference wraps its scan bodies in
``jax.checkpoint``.  All three attentions run on the port's kernels on a
CUDA tensor: the encoder's bidirectional self-attention and the decoder's
causal one through ``models.attention.apply_attention`` (flash), decode
self-attention through ``apply_attention_decode_paged`` (paged attention),
and cross-attention through ``kernels.flash_attention.ops.flash_attention``
at Sq != Sk (448 or 1 decoder rows over 1,500 frames), non-causal.

What the reference does, kept as it is: RoPE inside ``apply_attention`` on
top of the sinusoid (encoder) and learned (decoder) position tables; decoder
positions wrap modulo ``max_target_positions``; zero frame embeddings when
none are given; tied embeddings; cross K/V of the decode cache laid out
``(L, B, T_src, H, hd)``, batch on axis 1.
"""

from __future__ import annotations

from typing import Union

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.compat import DeviceLike, resolve_device
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models.attention import (apply_attention,
                                          apply_attention_decode_paged,
                                          init_attention, paged_write_slots)
from repro_torch.models.config import ModelConfig
from repro_torch.models.decoder import (_identity_page_table, _stack_layers,
                                        init_generator, unstack_layers)
from repro_torch.models.layers import (apply_mlp, apply_norm, dense_init,
                                       dtype_of, embed_init, init_mlp,
                                       init_norm, rope_tables,
                                       sinusoid_positions)


def _init_cross(gen: torch.Generator, cfg: ModelConfig, dtype):
    d, H, hd = cfg.d_model, cfg.n_heads, cfg.head_dim
    return {"wq": dense_init(gen, d, H * hd, dtype),
            "wk": dense_init(gen, d, H * hd, dtype),
            "wv": dense_init(gen, d, H * hd, dtype),
            "wo": dense_init(gen, H * hd, d, dtype)}


def init_params(cfg: ModelConfig, key: Union[int, torch.Generator] = 0,
                device: DeviceLike = None) -> dict:
    """Random parameters from a seed (or a ``torch.Generator``) on
    ``device`` (``None`` = the GPU).  The stream differs from the
    reference's; tests carry weights across with ``from_jax_params``."""
    gen, dev = init_generator(key, device)
    dtype = dtype_of(cfg.dtype)
    n_enc = cfg.n_enc_layers or cfg.n_layers

    def enc_layer():
        return {"norm1": init_norm(cfg.d_model, cfg.norm, dev),
                "attn": init_attention(gen, cfg, dtype),
                "norm2": init_norm(cfg.d_model, cfg.norm, dev),
                "mlp": init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.act, dtype)}

    def dec_layer():
        return {"norm1": init_norm(cfg.d_model, cfg.norm, dev),
                "self_attn": init_attention(gen, cfg, dtype),
                "norm_x": init_norm(cfg.d_model, cfg.norm, dev),
                "cross": _init_cross(gen, cfg, dtype),
                "norm2": init_norm(cfg.d_model, cfg.norm, dev),
                "mlp": init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.act, dtype)}

    return {
        "embed": embed_init(gen, cfg.vocab_size, cfg.d_model, dtype),
        "pos_dec": embed_init(gen, cfg.max_target_positions, cfg.d_model,
                              dtype),
        "enc_layers": _stack_layers(enc_layer, n_enc),
        "enc_norm": init_norm(cfg.d_model, cfg.norm, dev),
        "dec_layers": _stack_layers(dec_layer, cfg.n_layers),
        "final_norm": init_norm(cfg.d_model, cfg.norm, dev),
    }


# -------------------------------------------------------------------- encoder
def _enc_layer(lp, cfg: ModelConfig, x, positions, rope):
    h = apply_norm(lp["norm1"], x, cfg.norm, cfg.norm_eps)
    x = x + apply_attention(lp["attn"], cfg, h, positions, causal=False,
                            rope=rope)                  # bidirectional
    h = apply_norm(lp["norm2"], x, cfg.norm, cfg.norm_eps)
    return x + apply_mlp(lp["mlp"], h, cfg.act)


def encode(params, cfg: ModelConfig, frame_embeddings, remat: bool = False):
    """frame_embeddings: (B, T_src, d) — the stubbed conv frontend output."""
    B, T, d = frame_embeddings.shape
    dev = frame_embeddings.device
    x = frame_embeddings + sinusoid_positions(T, d, dev).to(
        frame_embeddings.dtype)
    positions = torch.arange(T, device=dev).expand(B, T)
    rope = rope_tables(positions, cfg.head_dim, cfg.rope_theta)
    for lp in unstack_layers(params["enc_layers"]):
        if remat:
            x = checkpoint(_enc_layer, lp, cfg, x, positions, rope,
                           use_reentrant=False)
        else:
            x = _enc_layer(lp, cfg, x, positions, rope)
    return apply_norm(params["enc_norm"], x, cfg.norm, cfg.norm_eps)


def _cross_attention(cp, cfg: ModelConfig, x, enc_kv):
    """x: (B, S, d) decoder rows over enc_kv = (k, v), each
    (B, T_src, H, hd): the flash kernels at Sq = S, Sk = T_src."""
    B, S, _ = x.shape
    H, hd = cfg.n_heads, cfg.head_dim
    k, v = enc_kv
    q = (x @ cp["wq"]).reshape(B, S, H, hd)
    out = flash_attention(q, k, v, causal=False)
    return out.reshape(B, S, H * hd) @ cp["wo"]


def _cross_kv_layer(cp, cfg: ModelConfig, enc_out):
    B, T, _ = enc_out.shape
    H, hd = cfg.n_heads, cfg.head_dim
    return ((enc_out @ cp["wk"]).reshape(B, T, H, hd),
            (enc_out @ cp["wv"]).reshape(B, T, H, hd))


def cross_kv(params, cfg: ModelConfig, enc_out):
    """Precompute ("pin") cross-attention K/V for all decoder layers:
    (k, v), each (L, B, T_src, H, hd)."""
    kv = [_cross_kv_layer(lp["cross"], cfg, enc_out)
          for lp in unstack_layers(params["dec_layers"])]
    return (torch.stack([k for k, _ in kv]), torch.stack([v for _, v in kv]))


# -------------------------------------------------------------------- decoder
def _dec_layer(lp, cfg: ModelConfig, x, enc_out, positions, rope):
    h = apply_norm(lp["norm1"], x, cfg.norm, cfg.norm_eps)
    x = x + apply_attention(lp["self_attn"], cfg, h, positions, rope=rope)
    h = apply_norm(lp["norm_x"], x, cfg.norm, cfg.norm_eps)
    x = x + _cross_attention(lp["cross"], cfg, h,
                             _cross_kv_layer(lp["cross"], cfg, enc_out))
    h = apply_norm(lp["norm2"], x, cfg.norm, cfg.norm_eps)
    return x + apply_mlp(lp["mlp"], h, cfg.act)


def forward(params, cfg: ModelConfig, tokens, frame_embeddings=None,
            embeddings=None, remat: bool = False, **_):
    """Teacher-forced decoder pass.  tokens: (B, S_dec) -> (logits
    (B, S_dec, V), 0.0).  ``embeddings`` stands in for absent
    ``frame_embeddings``, as in the reference; with neither, the encoder
    runs over zero frames of ``max_source_positions``."""
    B, S = tokens.shape
    dev = tokens.device
    if frame_embeddings is None:
        frame_embeddings = embeddings
    if frame_embeddings is None:
        frame_embeddings = torch.zeros(
            (B, cfg.max_source_positions, cfg.d_model),
            dtype=dtype_of(cfg.dtype), device=dev)
    enc_out = encode(params, cfg, frame_embeddings, remat=remat)
    pos = torch.arange(S, device=dev) % cfg.max_target_positions
    x = params["embed"][tokens.long()] + params["pos_dec"][pos][None]
    positions = torch.arange(S, device=dev).expand(B, S)
    rope = rope_tables(positions, cfg.head_dim, cfg.rope_theta)
    for lp in unstack_layers(params["dec_layers"]):
        if remat:
            x = checkpoint(_dec_layer, lp, cfg, x, enc_out, positions, rope,
                           use_reentrant=False)
        else:
            x = _dec_layer(lp, cfg, x, enc_out, positions, rope)
    x = apply_norm(params["final_norm"], x, cfg.norm, cfg.norm_eps)
    return x @ params["embed"].T, 0.0


def loss_fn(params, cfg: ModelConfig, tokens, labels, frame_embeddings=None,
            **kw):
    from repro_torch.models.losses import masked_xent
    logits, aux = forward(params, cfg, tokens, frame_embeddings, **kw)
    return masked_xent(logits, labels, aux)


# ================================================================== decoding
def init_decode_cache(cfg: ModelConfig, batch: int, max_len: int,
                      dtype=None, t_src: int = 0,
                      device: DeviceLike = None) -> dict:
    """``lengths`` (B,); paged self-attention pools ``k_pool`` / ``v_pool``
    (L, P, page, KVH, hd) and the identity ``page_table``; pinned
    cross-attention ``cross_k`` / ``cross_v`` (L, B, T_src, H, hd), zero
    until filled from :func:`cross_kv` (T_src defaults to
    ``max_source_positions``)."""
    dev = resolve_device(device)
    dtype = dtype or dtype_of(cfg.dtype)
    L = cfg.n_layers
    ps = cfg.kv_page_tokens
    n_pages = batch * (-(-max_len // ps))
    t_src = t_src or cfg.max_source_positions
    pool = (L, n_pages, ps, cfg.n_kv_heads, cfg.head_dim)
    cross = (L, batch, t_src, cfg.n_heads, cfg.head_dim)
    return {
        "lengths": torch.zeros((batch,), dtype=torch.int32, device=dev),
        "k_pool": torch.zeros(pool, dtype=dtype, device=dev),
        "v_pool": torch.zeros(pool, dtype=dtype, device=dev),
        "page_table": _identity_page_table(batch, max_len, ps, dev),
        "cross_k": torch.zeros(cross, dtype=dtype, device=dev),
        "cross_v": torch.zeros(cross, dtype=dtype, device=dev),
    }


def decode_step(params, cfg: ModelConfig, cache, tokens):
    """One decode step.  tokens: (B, 1) int -> (logits (B, 1, V), cache).

    The self-attention pools of ``cache`` are updated **in place**, as the
    decoder updates its pools; the returned dict shares them (and the
    pinned cross K/V, which a step only reads) and carries a new
    ``lengths`` tensor.  Nothing here is differentiated."""
    with torch.no_grad():
        B = tokens.shape[0]
        H, hd = cfg.n_heads, cfg.head_dim
        lengths = cache["lengths"] + 1
        pos = ((lengths - 1) % cfg.max_target_positions).long()
        x = params["embed"][tokens.long()] + params["pos_dec"][pos][:, None]
        new_cache = dict(cache, lengths=lengths)
        # shared by every layer of this step
        rope = rope_tables((lengths - 1)[:, None], hd, cfg.rope_theta)
        slots = paged_write_slots(cache["page_table"], lengths,
                                  cfg.kv_page_tokens)
        for li, lp in enumerate(unstack_layers(params["dec_layers"])):
            h = apply_norm(lp["norm1"], x, cfg.norm, cfg.norm_eps)
            attn, _, _ = apply_attention_decode_paged(
                lp["self_attn"], cfg, h, cache["k_pool"][li],
                cache["v_pool"][li], cache["page_table"], lengths, rope,
                slots)
            x = x + attn
            h = apply_norm(lp["norm_x"], x, cfg.norm, cfg.norm_eps)
            q = (h[:, 0] @ lp["cross"]["wq"]).reshape(B, 1, H, hd)
            cross = flash_attention(q, cache["cross_k"][li],
                                    cache["cross_v"][li], causal=False)
            x = x + cross.reshape(B, 1, H * hd) @ lp["cross"]["wo"]
            h = apply_norm(lp["norm2"], x, cfg.norm, cfg.norm_eps)
            x = x + apply_mlp(lp["mlp"], h, cfg.act)
        x = apply_norm(params["final_norm"], x, cfg.norm, cfg.norm_eps)
        return x @ params["embed"].T, new_cache
