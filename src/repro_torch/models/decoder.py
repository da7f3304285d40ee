"""Decoder-only LM assembly, ``dense`` family, decode path.

Parameters keep the reference's **stacked** layout — every per-layer
tensor carries a leading ``(L, ...)`` axis — so weights converted by
``compat.from_jax_params`` are a pure copy; a Python loop over that axis
takes the place of the reference's scan over layers.

Public surface (used by serving/, launch/):
    init_params(cfg, key, device=None)                    -> params dict
    init_decode_cache(cfg, batch, max_len, device=None)   -> cache dict
    decode_step(params, cfg, cache, tokens)               -> logits, cache

``forward`` / ``prefill`` / ``loss_fn`` and the moe / mla_moe families are
not ported yet.
"""

from __future__ import annotations

from typing import Any, Union

import torch

from repro_torch.compat import DeviceLike, resolve_device
from repro_torch.models.attention import (apply_attention_decode_paged,
                                          apply_attention_decode_ring,
                                          init_attention, paged_write_slots)
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (apply_mlp, apply_norm, dense_init,
                                       dtype_of, embed_init, init_mlp,
                                       init_norm, rope_tables)


# ------------------------------------------------------------------- helpers
def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _tree_leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tree_leaves(v)
    else:
        yield tree


def layer_slice(stacked, i: int):
    """Layer ``i`` of a stacked params dict (views, no copy)."""
    return _tree_map(lambda x: x[i], stacked)


# ---------------------------------------------------------------------- init
def _init_layer(gen: torch.Generator, cfg: ModelConfig, dtype):
    dev = gen.device
    return {"norm1": init_norm(cfg.d_model, cfg.norm, dev),
            "norm2": init_norm(cfg.d_model, cfg.norm, dev),
            "attn": init_attention(gen, cfg, dtype),
            "mlp": init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.act, dtype,
                            bias=cfg.mlp_bias)}


def _stack_layers(make_layer, n: int):
    """Stack ``n`` layers on a leading axis, filling one layer at a time:
    only one layer's f32 draws are alive beside the stacked tensors."""
    first = make_layer()
    stacked = _tree_map(
        lambda x: torch.empty((n,) + tuple(x.shape), dtype=x.dtype,
                              device=x.device), first)

    def put(dst, src, i):
        if isinstance(dst, dict):
            for k in dst:
                put(dst[k], src[k], i)
        else:
            dst[i].copy_(src)

    put(stacked, first, 0)
    del first
    for i in range(1, n):
        put(stacked, make_layer(), i)
    return stacked


def init_params(cfg: ModelConfig, key: Union[int, torch.Generator] = 0,
                device: DeviceLike = None) -> dict:
    """Random parameters from a seed (or a ``torch.Generator``) on
    ``device`` (``None`` = the GPU).  The stream differs from the
    reference's; tests carry weights across with ``from_jax_params``."""
    if isinstance(key, torch.Generator):
        gen = key
        dev = resolve_device(gen.device if device is None else device)
        if dev.type != gen.device.type:
            raise ValueError(f"generator on {gen.device}, device {dev}")
    else:
        dev = resolve_device(device)
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(key))
    dtype = dtype_of(cfg.dtype)
    n_dense, n_moe = _layer_split(cfg)
    if n_moe or cfg.mtp_depth:
        raise NotImplementedError(
            f"family {cfg.family!r}: expert / MTP layers are not ported yet")
    params: dict[str, Any] = {
        "embed": embed_init(gen, cfg.vocab_size, cfg.d_model, dtype),
        "final_norm": init_norm(cfg.d_model, cfg.norm, dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, cfg.d_model, cfg.vocab_size,
                                       dtype)
    if n_dense:
        params["dense_layers"] = _stack_layers(
            lambda: _init_layer(gen, cfg, dtype), n_dense)
    return params


def _layer_split(cfg: ModelConfig) -> tuple[int, int]:
    """(#dense-mlp layers, #moe layers) — deepseek has first_k_dense."""
    if cfg.family == "dense":
        return cfg.n_layers, 0
    if cfg.family == "moe":
        return 0, cfg.n_layers
    if cfg.family == "mla_moe":
        return cfg.first_k_dense, cfg.n_layers - cfg.first_k_dense
    raise ValueError(cfg.family)


# ================================================================== decoding
def uses_ring(cfg: ModelConfig) -> bool:
    return cfg.sliding_window > 0


def init_decode_cache(cfg: ModelConfig, batch: int, max_len: int,
                      dtype=None, device: DeviceLike = None) -> dict:
    """Cache dict for one-token decode.

    * full-attention archs: paged pools (L, P, page, KVH, hd) + page table;
    * SWA archs: ring buffers (L, B, W, KVH, hd) — the resident window.
    Both include ``lengths`` (B,) of tokens seen so far.
    """
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r}: decode cache not ported yet")
    dev = resolve_device(device)
    dtype = dtype or dtype_of(cfg.dtype)
    L = cfg.n_layers
    cache: dict[str, Any] = {
        "lengths": torch.zeros((batch,), dtype=torch.int32, device=dev)}
    if uses_ring(cfg):
        W = cfg.sliding_window
        shape = (L, batch, W, cfg.n_kv_heads, cfg.head_dim)
        cache["k_ring"] = torch.zeros(shape, dtype=dtype, device=dev)
        cache["v_ring"] = torch.zeros(shape, dtype=dtype, device=dev)
    else:
        ps = cfg.kv_page_tokens
        n_pages = batch * (-(-max_len // ps))
        shape = (L, n_pages, ps, cfg.n_kv_heads, cfg.head_dim)
        cache["k_pool"] = torch.zeros(shape, dtype=dtype, device=dev)
        cache["v_pool"] = torch.zeros(shape, dtype=dtype, device=dev)
        cache["page_table"] = _identity_page_table(batch, max_len, ps, dev)
    return cache


def _identity_page_table(batch: int, max_len: int, ps: int, device="cpu"):
    per_seq = -(-max_len // ps)
    return (torch.arange(batch * per_seq, dtype=torch.int32, device=device)
            .reshape(batch, per_seq))


def decode_step(params, cfg: ModelConfig, cache, tokens):
    """One decode step.  tokens: (B, 1) int -> (logits (B,1,V), cache).

    The KV pools / rings of ``cache`` are updated **in place** (a copy of a
    full-width pool per step would cost more than the step); the returned
    dict shares them and carries a new ``lengths`` tensor.  Runs under
    ``torch.no_grad`` semantics: nothing here is differentiated.
    """
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r}: decode_step not ported yet")
    with torch.no_grad():
        x = params["embed"][tokens.long()]
        lengths = cache["lengths"] + 1
        new_cache = dict(cache, lengths=lengths)
        layers = params["dense_layers"]
        n = next(_tree_leaves(layers)).shape[0]
        ring = uses_ring(cfg)
        # what every layer of this step shares: RoPE tables of the current
        # positions and, for the paged cache, the rows the new K/V go to
        rope = rope_tables((lengths - 1)[:, None], cfg.head_dim,
                           cfg.rope_theta)
        slots = None if ring else paged_write_slots(
            cache["page_table"], lengths, cfg.kv_page_tokens)
        for i in range(n):
            lp = layer_slice(layers, i)
            h = apply_norm(lp["norm1"], x, cfg.norm, cfg.norm_eps)
            if ring:
                attn, _, _ = apply_attention_decode_ring(
                    lp["attn"], cfg, h, new_cache["k_ring"][i],
                    new_cache["v_ring"][i], lengths, rope)
            else:
                attn, _, _ = apply_attention_decode_paged(
                    lp["attn"], cfg, h, new_cache["k_pool"][i],
                    new_cache["v_pool"][i], cache["page_table"], lengths,
                    rope, slots)
            x = x + attn
            h = apply_norm(lp["norm2"], x, cfg.norm, cfg.norm_eps)
            x = x + apply_mlp(lp["mlp"], h, cfg.act)
        x = apply_norm(params["final_norm"], x, cfg.norm, cfg.norm_eps)
        head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
        return x @ head, new_cache
