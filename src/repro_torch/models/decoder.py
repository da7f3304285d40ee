"""Decoder-only LM assembly: the dense / moe / mla_moe families.

Parameters keep the reference's **stacked** layout — every per-layer
tensor carries a leading ``(L, ...)`` axis — so weights converted by
``compat.from_jax_params`` are a pure copy; a Python loop over that axis
takes the place of the reference's scan over layers, and
``torch.utils.checkpoint`` per layer takes the place of ``jax.checkpoint``
on the scan body (``remat=True``).  A model holds up to two stacks,
``dense_layers`` (MLP) and ``moe_layers`` (experts; DeepSeek-V3's come
after its ``first_k_dense`` dense layers), run in that order.

Public surface (used by training/, serving/, launch/):
    init_params(cfg, key, device=None)                    -> params dict
    forward(params, cfg, tokens)                          -> logits, aux
    loss_fn(params, cfg, tokens, labels)                  -> scalar
    prefill(params, cfg, tokens)                          -> logits, aux, kv
    init_decode_cache(cfg, batch, max_len, device=None)   -> cache dict
    decode_step(params, cfg, cache, tokens)               -> logits, cache
"""

from __future__ import annotations

from typing import Any, Optional, Union

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.compat import DeviceLike, resolve_device
from repro_torch.models import mla as mla_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models.attention import (apply_attention,
                                          apply_attention_decode_paged,
                                          apply_attention_decode_ring,
                                          init_attention, paged_write_slots)
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (apply_mlp, apply_norm, dense_init,
                                       dtype_of, embed_init, init_mlp,
                                       init_norm, rope_tables)
from repro_torch.tree import tree_leaves, tree_map

# the layer stacks, in the order they run; True: the stack's FFN is MoE
STACKS = (("dense_layers", False), ("moe_layers", True))


# ------------------------------------------------------------------- helpers
def layer_slice(stacked, i: int):
    """Layer ``i`` of a stacked params dict (views, no copy)."""
    return tree_map(lambda x: x[i], stacked)


def unstack_layers(stacked) -> list:
    """Every layer of a stacked params dict, as views made by one
    ``unbind`` per leaf: its backward stacks the layers' gradients once,
    where a separate slice per layer would add an (L, ...) tensor per
    layer."""
    parts = tree_map(lambda x: x.unbind(0), stacked)
    n = len(tree_leaves(parts)[0])
    return [tree_map(lambda u: u[i], parts) for i in range(n)]


# ---------------------------------------------------------------------- init
def _init_layer(gen: torch.Generator, cfg: ModelConfig, dtype, moe: bool):
    dev = gen.device
    p = {"norm1": init_norm(cfg.d_model, cfg.norm, dev),
         "norm2": init_norm(cfg.d_model, cfg.norm, dev)}
    if cfg.family == "mla_moe":
        p["attn"] = mla_mod.init_mla(gen, cfg, dtype)
    else:
        p["attn"] = init_attention(gen, cfg, dtype)
    if moe:
        p["moe"] = moe_mod.init_moe(gen, cfg, dtype)
    else:
        p["mlp"] = init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.act, dtype,
                            bias=cfg.mlp_bias)
    return p


def _stack_layers(make_layer, n: int):
    """Stack ``n`` layers on a leading axis, filling one layer at a time:
    only one layer's f32 draws are alive beside the stacked tensors.  A
    stack of one is the layer itself with a leading axis (no copy: a
    DeepSeek-V3 MoE layer is 22.5 GB in bf16)."""
    first = make_layer()
    if n == 1:
        return tree_map(lambda x: x.unsqueeze(0), first)
    stacked = tree_map(
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


def init_generator(key: Union[int, torch.Generator],
                   device: DeviceLike) -> tuple:
    """(generator, device) of an ``init_params``: a seed makes a generator
    on ``device`` (``None`` = the GPU); a generator is used as given, on
    its own device unless ``device`` names one of the same type."""
    if isinstance(key, torch.Generator):
        dev = resolve_device(key.device if device is None else device)
        if dev.type != key.device.type:
            raise ValueError(f"generator on {key.device}, device {dev}")
        return key, dev
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(key))
    return gen, dev


def init_params(cfg: ModelConfig, key: Union[int, torch.Generator] = 0,
                device: DeviceLike = None) -> dict:
    """Random parameters from a seed (or a ``torch.Generator``) on
    ``device`` (``None`` = the GPU).  The stream differs from the
    reference's; tests carry weights across with ``from_jax_params``."""
    gen, dev = init_generator(key, device)
    dtype = dtype_of(cfg.dtype)
    n_dense, n_moe = _layer_split(cfg)
    params: dict[str, Any] = {
        "embed": embed_init(gen, cfg.vocab_size, cfg.d_model, dtype),
        "final_norm": init_norm(cfg.d_model, cfg.norm, dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, cfg.d_model, cfg.vocab_size,
                                       dtype)
    if n_dense:
        params["dense_layers"] = _stack_layers(
            lambda: _init_layer(gen, cfg, dtype, moe=False), n_dense)
    if n_moe:
        params["moe_layers"] = _stack_layers(
            lambda: _init_layer(gen, cfg, dtype, moe=True), n_moe)
    if cfg.mtp_depth:       # initialised only, as in the reference
        params["mtp"] = _stack_layers(
            lambda: _init_layer(gen, cfg, dtype, moe=cfg.n_experts > 0),
            cfg.mtp_depth)
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


# ------------------------------------------------------------- layer bodies
def _apply_layer(lp, cfg: ModelConfig, x, positions, rope, moe: bool,
                 q_chunk: int, kv_chunk: int, return_kv: bool):
    """-> (x, aux, kv): ``aux`` is the layer's MoE loss (0.0 for an MLP
    layer), ``kv`` its (k, v) with ``return_kv`` (None for MLA)."""
    h = apply_norm(lp["norm1"], x, cfg.norm, cfg.norm_eps)
    if cfg.family == "mla_moe":
        attn_out = mla_mod.apply_mla(lp["attn"], cfg, h, positions,
                                     q_chunk=q_chunk, kv_chunk=kv_chunk)
        kv = None
    else:
        res = apply_attention(lp["attn"], cfg, h, positions, q_chunk=q_chunk,
                              kv_chunk=kv_chunk, return_kv=return_kv,
                              rope=rope)
        attn_out, kv = res if return_kv else (res, None)
    x = x + attn_out
    h = apply_norm(lp["norm2"], x, cfg.norm, cfg.norm_eps)
    if moe:
        y, aux = moe_mod.apply_moe(lp["moe"], cfg, h)
    else:
        y, aux = apply_mlp(lp["mlp"], h, cfg.act), 0.0
    return x + y, aux, kv


# -------------------------------------------------------------------- forward
def forward(params, cfg: ModelConfig, tokens, *, q_chunk: int = 512,
            kv_chunk: int = 512, collect_kv: bool = False,
            embeddings: Optional[torch.Tensor] = None, remat: bool = False):
    """tokens: (B, S) int -> logits (B, S, V), aux [, kv_stacks].

    ``embeddings`` overrides the token embedding.  ``remat=True`` keeps
    only the layer boundaries and recomputes each layer in the backward
    (``torch.utils.checkpoint``, non-reentrant).  ``kv_stacks`` (with
    ``collect_kv``) maps each stack's name to (k, v), each (L, B, S, KVH,
    hd) — None for MLA, which has no per-head cache.  ``aux`` is the sum of
    the MoE layers' auxiliary losses (0.0 without MoE layers).
    """
    x = params["embed"][tokens.long()] if embeddings is None else embeddings
    B, S = x.shape[:2]
    positions = torch.arange(S, device=x.device).expand(B, S)
    rope = None if cfg.family == "mla_moe" else \
        rope_tables(positions, cfg.head_dim, cfg.rope_theta)
    aux_total = 0.0
    kv_stacks = {}
    for name, moe in STACKS:
        if name not in params:
            continue
        ks, vs = [], []
        for lp in unstack_layers(params[name]):
            if remat:
                x, aux, kv = checkpoint(_apply_layer, lp, cfg, x, positions,
                                        rope, moe, q_chunk, kv_chunk,
                                        collect_kv, use_reentrant=False)
            else:
                x, aux, kv = _apply_layer(lp, cfg, x, positions, rope, moe,
                                          q_chunk, kv_chunk, collect_kv)
            aux_total = aux_total + aux
            if kv is not None:
                ks.append(kv[0])
                vs.append(kv[1])
        if collect_kv:
            kv_stacks[name] = (torch.stack(ks), torch.stack(vs)) if ks \
                else None
    x = apply_norm(params["final_norm"], x, cfg.norm, cfg.norm_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = x @ head
    if collect_kv:
        return logits, aux_total, kv_stacks
    return logits, aux_total


def loss_fn(params, cfg: ModelConfig, tokens, labels, *, q_chunk: int = 512,
            kv_chunk: int = 512, remat: bool = False):
    from repro_torch.models.losses import masked_xent
    logits, aux = forward(params, cfg, tokens, q_chunk=q_chunk,
                          kv_chunk=kv_chunk, remat=remat)
    return masked_xent(logits, labels, aux)


def prefill(params, cfg: ModelConfig, tokens, *, q_chunk: int = 512,
            kv_chunk: int = 512):
    """Prefill pass: logits + per-layer K/V to be packed into the pools
    (none for MLA, whose latent cache is filled by ``decode_step``)."""
    return forward(params, cfg, tokens, q_chunk=q_chunk, kv_chunk=kv_chunk,
                   collect_kv=(cfg.family != "mla_moe"))


# ================================================================== decoding
def uses_ring(cfg: ModelConfig) -> bool:
    return cfg.sliding_window > 0


def init_decode_cache(cfg: ModelConfig, batch: int, max_len: int,
                      dtype=None, device: DeviceLike = None) -> dict:
    """Cache dict for one-token decode.

    * full-attention archs: paged pools (L, P, page, KVH, hd) + page table;
    * SWA archs: ring buffers (L, B, W, KVH, hd) — the resident window;
    * MLA: paged latent pools (L, P, page, kv_lora_rank / rope) + page
      table.
    All include ``lengths`` (B,) of tokens seen so far.
    """
    dev = resolve_device(device)
    dtype = dtype or dtype_of(cfg.dtype)
    L = cfg.n_layers
    cache: dict[str, Any] = {
        "lengths": torch.zeros((batch,), dtype=torch.int32, device=dev)}
    ps = cfg.kv_page_tokens
    n_pages = batch * (-(-max_len // ps))
    if cfg.family == "mla_moe":
        cache["ckv_pool"] = torch.zeros((L, n_pages, ps, cfg.kv_lora_rank),
                                        dtype=dtype, device=dev)
        cache["krope_pool"] = torch.zeros(
            (L, n_pages, ps, cfg.qk_rope_head_dim), dtype=dtype, device=dev)
        cache["page_table"] = _identity_page_table(batch, max_len, ps, dev)
    elif uses_ring(cfg):
        W = cfg.sliding_window
        shape = (L, batch, W, cfg.n_kv_heads, cfg.head_dim)
        cache["k_ring"] = torch.zeros(shape, dtype=dtype, device=dev)
        cache["v_ring"] = torch.zeros(shape, dtype=dtype, device=dev)
    else:
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
    dict shares them and carries a new ``lengths`` tensor.  Layer ``i`` of
    the ``moe_layers`` stack uses the cache's layer ``n_dense + i``.  MoE
    layers dispatch dropless.  Runs under ``torch.no_grad`` semantics:
    nothing here is differentiated.
    """
    with torch.no_grad():
        x = params["embed"][tokens.long()]
        lengths = cache["lengths"] + 1
        new_cache = dict(cache, lengths=lengths)
        mla = cfg.family == "mla_moe"
        ring = not mla and uses_ring(cfg)
        # what every GQA layer of this step shares: RoPE tables of the
        # current positions and, for the paged cache, the rows the new K/V
        # go to
        rope = slots = None
        if not mla:
            rope = rope_tables((lengths - 1)[:, None], cfg.head_dim,
                               cfg.rope_theta)
            if not ring:
                slots = paged_write_slots(cache["page_table"], lengths,
                                          cfg.kv_page_tokens)
        layer_idx = 0
        for name, moe in STACKS:
            if name not in params:
                continue
            layers = params[name]
            n = tree_leaves(layers)[0].shape[0]
            for i in range(n):
                lp = layer_slice(layers, i)
                li = layer_idx + i
                h = apply_norm(lp["norm1"], x, cfg.norm, cfg.norm_eps)
                if mla:
                    attn, _, _ = mla_mod.apply_mla_decode_paged(
                        lp["attn"], cfg, h, new_cache["ckv_pool"][li],
                        new_cache["krope_pool"][li], cache["page_table"],
                        lengths)
                elif ring:
                    attn, _, _ = apply_attention_decode_ring(
                        lp["attn"], cfg, h, new_cache["k_ring"][li],
                        new_cache["v_ring"][li], lengths, rope)
                else:
                    attn, _, _ = apply_attention_decode_paged(
                        lp["attn"], cfg, h, new_cache["k_pool"][li],
                        new_cache["v_pool"][li], cache["page_table"],
                        lengths, rope, slots)
                x = x + attn
                h = apply_norm(lp["norm2"], x, cfg.norm, cfg.norm_eps)
                if moe:
                    y, _ = moe_mod.apply_moe(lp["moe"], cfg, h,
                                             dropless=True)
                else:
                    y = apply_mlp(lp["mlp"], h, cfg.act)
                x = x + y
            layer_idx += n
        x = apply_norm(params["final_norm"], x, cfg.norm, cfg.norm_eps)
        head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
        return x @ head, new_cache

