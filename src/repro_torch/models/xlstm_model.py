"""xLSTM LM assembly: mLSTM blocks with sLSTM blocks at ``slstm_at``.

The mLSTM runs between the sLSTM blocks are stacked with a leading layer
axis, as the reference stacks them for its scan; a Python loop over that
axis takes the place of the scan, and ``remat=True`` wraps each mLSTM
layer in ``torch.utils.checkpoint`` where the reference wraps its scan
body in ``jax.checkpoint``.  The few sLSTM blocks stay single.
Attention-free: decode carries fixed-size recurrent state only, pinned
whole (no KV pages, no kernel of this repo on the path).

**One layout difference from the reference**, in the decode cache: each
sLSTM segment's leaves ``c``, ``n``, ``h``, ``m`` are ``(1, B, d)`` where
the reference's are ``(B, d)``.  The serving engine's rule is that every
cache leaf but ``lengths``, pools and tables carries the batch on axis 1
(``serving/engine.py``, ``_copy_in``); the mLSTM leaves ``(L_seg, B,
...)`` keep it, and with the leading axis the sLSTM leaves keep it too, so
the engine copies whole sequences.  (The reference engine copies only
column 0 of a ``(B, d)`` leaf, and fails at a batch above one.)
``decode_step`` reads and writes ``[0]`` of them.
"""

from __future__ import annotations

from typing import Any, Optional, Union

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.compat import DeviceLike, resolve_device
from repro_torch.distributed.logical import grad_like
from repro_torch.models import xlstm as cells
from repro_torch.models.config import ModelConfig
from repro_torch.models.decoder import (_laid_out, _stack_layers,
                                        init_generator, unstack_layers)
from repro_torch.models.layers import (apply_norm, dense_init, dtype_of,
                                       embed, embed_init, init_norm)


def segments(cfg: ModelConfig):
    """Split layer indices into alternating (mlstm-run, slstm) segments."""
    sl = sorted(cfg.slstm_at)
    segs = []
    start = 0
    for s in sl:
        segs.append(("m", start, s))      # mlstm layers [start, s)
        segs.append(("s", s, s + 1))
        start = s + 1
    segs.append(("m", start, cfg.n_layers))
    return [x for x in segs if x[2] > x[1]]


def init_params(cfg: ModelConfig, key: Union[int, torch.Generator] = 0,
                device: DeviceLike = None) -> dict:
    """Random parameters from a seed (or a ``torch.Generator``) on
    ``device`` (``None`` = the GPU).  The stream differs from the
    reference's; tests carry weights across with ``from_jax_params``."""
    gen, dev = init_generator(key, device)
    dtype = dtype_of(cfg.dtype)
    params: dict[str, Any] = {
        "embed": embed_init(gen, cfg.vocab_size, cfg.d_model, dtype),
        "final_norm": init_norm(cfg.d_model, cfg.norm, dev),
        "lm_head": dense_init(gen, cfg.d_model, cfg.vocab_size, dtype),
    }

    def mlstm_layer():
        return {"norm": init_norm(cfg.d_model, cfg.norm, dev),
                "cell": cells.init_mlstm(gen, cfg, dtype)}

    for si, (kind, a, b) in enumerate(segments(cfg)):
        if kind == "m":
            params[f"seg{si}"] = _stack_layers(mlstm_layer, b - a)
        else:
            params[f"seg{si}"] = {
                "norm": init_norm(cfg.d_model, cfg.norm, dev),
                "cell": cells.init_slstm(gen, cfg, dtype)}
    return params


def _mlstm_layer(lp, cfg: ModelConfig, x):
    h = apply_norm(lp["norm"], x, cfg.norm, cfg.norm_eps)
    return x + cells.apply_mlstm(lp["cell"], cfg, h)


def forward(params, cfg: ModelConfig, tokens, *,
            embeddings: Optional[torch.Tensor] = None, remat: bool = False):
    """tokens: (B, S) int -> (logits (B, S, V), 0.0).  ``embeddings``
    overrides the token embedding; ``remat=True`` checkpoints each mLSTM
    layer (non-reentrant)."""
    x = embed(params["embed"], tokens) if embeddings is None else embeddings
    for si, (kind, a, b) in enumerate(segments(cfg)):
        sp = params[f"seg{si}"]
        if kind == "m":
            for lp in unstack_layers(sp):
                x = checkpoint(_mlstm_layer, lp, cfg, x, use_reentrant=False) \
                    if remat else _mlstm_layer(lp, cfg, x)
        else:
            h = apply_norm(sp["norm"], x, cfg.norm, cfg.norm_eps)
            x = x + cells.apply_slstm(sp["cell"], cfg, h)
    x = apply_norm(params["final_norm"], x, cfg.norm, cfg.norm_eps)
    return grad_like(x @ params["lm_head"]), 0.0


def loss_fn(params, cfg: ModelConfig, tokens, labels, **kw):
    from repro_torch.models.losses import masked_xent
    logits, aux = forward(params, cfg, tokens, **kw)
    return masked_xent(logits, labels, aux)


# ================================================================== decoding
def init_decode_cache(cfg: ModelConfig, batch: int, max_len: int = 0,
                      dtype=None, device: DeviceLike = None) -> dict:
    """``lengths`` (B,); per mLSTM segment its states stacked ``(L_seg, B,
    ...)``; per sLSTM segment its states ``(1, B, d)`` (module docstring).
    Every state is f32; ``max_len`` and ``dtype`` are not read (no KV).
    Under logical rules on a DeviceMesh each leaf is a DTensor laid out by
    ``distributed.sharding.cache_shardings``."""
    dev = resolve_device(device)
    cache: dict[str, Any] = {
        "lengths": torch.zeros((batch,), dtype=torch.int32, device=dev)}
    for si, (kind, a, b) in enumerate(segments(cfg)):
        if kind == "m":
            st = cells.init_mlstm_state(cfg, batch, device=dev)
            cache[f"seg{si}"] = {
                k: v.expand((b - a,) + tuple(v.shape)).clone()
                for k, v in st.items()}
        else:
            st = cells.init_slstm_state(cfg, batch, device=dev)
            cache[f"seg{si}"] = {k: v[None] for k, v in st.items()}
    return _laid_out(cache, batch)


def _update(stacked: dict, i: int, new: dict) -> None:
    for k, t in stacked.items():
        t[i].copy_(new[k])


def decode_step(params, cfg: ModelConfig, cache, tokens):
    """One decode step.  tokens: (B, 1) int -> (logits (B,1,V), cache).

    The states of ``cache`` are updated **in place**, as the other
    families update theirs; the returned dict shares them and carries a
    new ``lengths`` tensor.  Nothing here is differentiated."""
    with torch.no_grad():
        x = embed(params["embed"], tokens)
        new_cache = dict(cache, lengths=cache["lengths"] + 1)
        for si, (kind, a, b) in enumerate(segments(cfg)):
            sp, st = params[f"seg{si}"], cache[f"seg{si}"]
            if kind == "m":
                for j, lp in enumerate(unstack_layers(sp)):
                    h = apply_norm(lp["norm"], x, cfg.norm, cfg.norm_eps)
                    y, new = cells.apply_mlstm_decode(
                        lp["cell"], cfg, h, {k: t[j] for k, t in st.items()})
                    _update(st, j, new)
                    x = x + y
            else:
                h = apply_norm(sp["norm"], x, cfg.norm, cfg.norm_eps)
                y, new = cells.apply_slstm_decode(
                    sp["cell"], cfg, h, {k: t[0] for k, t in st.items()})
                _update(st, 0, new)
                x = x + y
        x = apply_norm(params["final_norm"], x, cfg.norm, cfg.norm_eps)
        return x @ params["lm_head"], new_cache
