"""Zamba2-style hybrid: Mamba2 backbone + one *shared* attention block.

Layout (attn_every = k): the L Mamba2 blocks are split into groups of k;
after each full group the single shared transformer block (attention + MLP,
one weight set reused at every application) runs.  L = 81, k = 6 gives 13
shared-attention applications plus a 3-block tail.

Parameters keep the reference's layout: the groups' Mamba layers stacked
twice, ``(G, k, ...)``, the tail's once, ``(tail, ...)``; Python loops over
those axes take the place of the reference's scans, and with
``remat=True`` each layer and each group is wrapped in
``torch.utils.checkpoint`` where the reference wraps its scan bodies in
``jax.checkpoint``.  The shared block's attention calls the flash-attention
kernels (``models.attention.apply_attention``).

Decode state = per-layer Mamba2 (ssm, conv) states (pinned, stacked
``(L, B, ...)``) + one paged KV pool per shared-attention *application
site* (13 sites share weights but not caches), read through
``paged_attention`` — the pinned-vs-paged contrast of the thesis.
"""

from __future__ import annotations

from typing import Any, Optional, Union

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.compat import DeviceLike, resolve_device
from repro_torch.models import mamba as mamba_mod
from repro_torch.models.attention import (apply_attention,
                                          apply_attention_decode_paged,
                                          init_attention, paged_write_slots)
from repro_torch.models.config import ModelConfig
from repro_torch.models.decoder import (_identity_page_table, _stack_layers,
                                        init_generator, unstack_layers)
from repro_torch.models.layers import (apply_mlp, apply_norm, dense_init,
                                       dtype_of, embed_init, init_mlp,
                                       init_norm, rope_tables)
from repro_torch.tree import tree_map


def group_layout(cfg: ModelConfig) -> tuple[int, int, int]:
    """(n_groups, group_size, tail)."""
    k = max(1, cfg.attn_every)
    n_groups = cfg.n_layers // k
    tail = cfg.n_layers - n_groups * k
    return n_groups, k, tail


def init_params(cfg: ModelConfig, key: Union[int, torch.Generator] = 0,
                device: DeviceLike = None) -> dict:
    """Random parameters from a seed (or a ``torch.Generator``) on
    ``device`` (``None`` = the GPU).  The stream differs from the
    reference's; tests carry weights across with ``from_jax_params``."""
    gen, dev = init_generator(key, device)
    dtype = dtype_of(cfg.dtype)
    n_groups, k, tail = group_layout(cfg)

    def mamba_layer():
        return {"norm": init_norm(cfg.d_model, cfg.norm, dev),
                "mamba": mamba_mod.init_mamba(gen, cfg, dtype)}

    # layers 0 .. G·k - 1 fill the groups, the rest the tail, in draw order
    grouped = _stack_layers(mamba_layer, n_groups * k)
    params: dict[str, Any] = {
        "embed": embed_init(gen, cfg.vocab_size, cfg.d_model, dtype),
        "final_norm": init_norm(cfg.d_model, cfg.norm, dev),
        "lm_head": dense_init(gen, cfg.d_model, cfg.vocab_size, dtype),
        "groups": tree_map(lambda t: t.reshape((n_groups, k) + t.shape[1:]),
                           grouped),                    # (G, k, ...)
        "shared": {
            "norm1": init_norm(cfg.d_model, cfg.norm, dev),
            "attn": init_attention(gen, cfg, dtype),
            "norm2": init_norm(cfg.d_model, cfg.norm, dev),
            "mlp": init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.act, dtype),
        },
    }
    if tail:
        params["tail"] = _stack_layers(mamba_layer, tail)
    return params


# -------------------------------------------------------------------- forward
def _mamba_layer(lp, cfg: ModelConfig, x, chunk: int):
    h = apply_norm(lp["norm"], x, cfg.norm, cfg.norm_eps)
    return x + mamba_mod.apply_mamba(lp["mamba"], cfg, h, chunk=chunk)


def _mamba_layers(stacked, cfg: ModelConfig, x, chunk: int, remat: bool):
    for lp in unstack_layers(stacked):
        if remat:
            x = checkpoint(_mamba_layer, lp, cfg, x, chunk,
                           use_reentrant=False)
        else:
            x = _mamba_layer(lp, cfg, x, chunk)
    return x


def _shared_attn(sp, cfg: ModelConfig, x, positions, rope, q_chunk: int,
                 kv_chunk: int):
    h = apply_norm(sp["norm1"], x, cfg.norm, cfg.norm_eps)
    x = x + apply_attention(sp["attn"], cfg, h, positions, q_chunk=q_chunk,
                            kv_chunk=kv_chunk, rope=rope)
    h = apply_norm(sp["norm2"], x, cfg.norm, cfg.norm_eps)
    return x + apply_mlp(sp["mlp"], h, cfg.act)


def _group(glp, sp, cfg: ModelConfig, x, positions, rope, q_chunk: int,
           kv_chunk: int, ssm_chunk: int, remat: bool):
    x = _mamba_layers(glp, cfg, x, ssm_chunk, remat)
    return _shared_attn(sp, cfg, x, positions, rope, q_chunk, kv_chunk)


def forward(params, cfg: ModelConfig, tokens, *, q_chunk: int = 512,
            kv_chunk: int = 512, ssm_chunk: int = 128,
            embeddings: Optional[torch.Tensor] = None, remat: bool = False):
    """tokens: (B, S) int -> (logits (B, S, V), 0.0).

    ``embeddings`` overrides the token embedding.  ``remat=True`` keeps
    only the boundaries of every layer and of every group, recomputing
    them in the backward (``torch.utils.checkpoint``, non-reentrant, nested
    as the reference nests ``jax.checkpoint``)."""
    x = params["embed"][tokens.long()] if embeddings is None else embeddings
    B, S = x.shape[:2]
    positions = torch.arange(S, device=x.device).expand(B, S)
    rope = rope_tables(positions, cfg.head_dim, cfg.rope_theta)
    sp = params["shared"]
    for glp in unstack_layers(params["groups"]):
        args = (glp, sp, cfg, x, positions, rope, q_chunk, kv_chunk,
                ssm_chunk, remat)
        x = checkpoint(_group, *args, use_reentrant=False) if remat \
            else _group(*args)
    if "tail" in params:
        x = _mamba_layers(params["tail"], cfg, x, ssm_chunk, remat)
    x = apply_norm(params["final_norm"], x, cfg.norm, cfg.norm_eps)
    return x @ params["lm_head"], 0.0


def loss_fn(params, cfg: ModelConfig, tokens, labels, **kw):
    from repro_torch.models.losses import masked_xent
    logits, aux = forward(params, cfg, tokens, **kw)
    return masked_xent(logits, labels, aux)


# ================================================================== decoding
def init_decode_cache(cfg: ModelConfig, batch: int, max_len: int,
                      dtype=None, device: DeviceLike = None) -> dict:
    """``lengths`` (B,); ``ssm``: the Mamba states stacked ``(L, B, ...)``
    per leaf; ``k_pool`` / ``v_pool`` (G, P, page, KVH, hd), one pool per
    shared-attention site; the identity ``page_table``."""
    dev = resolve_device(device)
    dtype = dtype or dtype_of(cfg.dtype)
    n_groups, k, tail = group_layout(cfg)
    ps = cfg.kv_page_tokens
    n_pages = batch * (-(-max_len // ps))
    st = mamba_mod.init_mamba_state(cfg, batch, dtype=dtype, device=dev)
    pool = (n_groups, n_pages, ps, cfg.n_kv_heads, cfg.head_dim)
    return {
        "lengths": torch.zeros((batch,), dtype=torch.int32, device=dev),
        "ssm": {name: torch.zeros((cfg.n_layers,) + tuple(t.shape),
                                  dtype=t.dtype, device=dev)
                for name, t in st.items()},
        "k_pool": torch.zeros(pool, dtype=dtype, device=dev),
        "v_pool": torch.zeros(pool, dtype=dtype, device=dev),
        "page_table": _identity_page_table(batch, max_len, ps, dev),
    }


def _mamba_decode_layer(lp, cfg: ModelConfig, x, ssm, li: int):
    """Layer ``li``'s step; its state in ``ssm`` is updated in place."""
    h = apply_norm(lp["norm"], x, cfg.norm, cfg.norm_eps)
    st = {name: t[li] for name, t in ssm.items()}
    y, new = mamba_mod.apply_mamba_decode(lp["mamba"], cfg, h, st)
    for name, t in st.items():
        t.copy_(new[name])
    return x + y


def decode_step(params, cfg: ModelConfig, cache, tokens):
    """One decode step.  tokens: (B, 1) int -> (logits (B,1,V), cache).

    The Mamba states and the KV pools of ``cache`` are updated **in
    place**, as the decoder updates its pools; the returned dict shares
    them and carries a new ``lengths`` tensor.  Site ``g`` (after group
    ``g``) uses pool slice ``g``.  Nothing here is differentiated."""
    with torch.no_grad():
        x = params["embed"][tokens.long()]
        n_groups, k, tail = group_layout(cfg)
        lengths = cache["lengths"] + 1
        new_cache = dict(cache, lengths=lengths)
        sp = params["shared"]
        ssm = cache["ssm"]
        # shared by every site of this step
        rope = rope_tables((lengths - 1)[:, None], cfg.head_dim,
                           cfg.rope_theta)
        slots = paged_write_slots(cache["page_table"], lengths,
                                  cfg.kv_page_tokens)
        for g, glp in enumerate(unstack_layers(params["groups"])):
            for j, lp in enumerate(unstack_layers(glp)):
                x = _mamba_decode_layer(lp, cfg, x, ssm, g * k + j)
            h = apply_norm(sp["norm1"], x, cfg.norm, cfg.norm_eps)
            attn, _, _ = apply_attention_decode_paged(
                sp["attn"], cfg, h, cache["k_pool"][g], cache["v_pool"][g],
                cache["page_table"], lengths, rope, slots)
            x = x + attn
            h = apply_norm(sp["norm2"], x, cfg.norm, cfg.norm_eps)
            x = x + apply_mlp(sp["mlp"], h, cfg.act)
        if tail:
            for j, lp in enumerate(unstack_layers(params["tail"])):
                x = _mamba_decode_layer(lp, cfg, x, ssm, n_groups * k + j)
        x = apply_norm(params["final_norm"], x, cfg.norm, cfg.norm_eps)
        return x @ params["lm_head"], new_cache
