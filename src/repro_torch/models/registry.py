"""Family → module dispatch.  Every ported family exposes the same surface:

    init_params(cfg, key, device=None)
    forward(params, cfg, tokens, **kw)                  -> (logits, aux)
    loss_fn(params, cfg, tokens, labels)                -> scalar
    init_decode_cache(cfg, batch, max_len, device=None) -> cache dict
    decode_step(params, cfg, cache, tokens)             -> (logits, cache)

The encoder-decoder family's ``forward`` / ``loss_fn`` also take
``frame_embeddings`` (zeros when absent, as in the reference).
"""

from __future__ import annotations

from types import SimpleNamespace

from repro_torch.models import decoder, encdec, hybrid
from repro_torch.models.config import ModelConfig

_DECODER = SimpleNamespace(
    init_params=decoder.init_params,
    forward=decoder.forward,
    loss_fn=decoder.loss_fn,
    init_decode_cache=decoder.init_decode_cache,
    decode_step=decoder.decode_step,
)

_FAMILIES = {
    "dense": _DECODER,
    "moe": _DECODER,
    "mla_moe": _DECODER,
    "hybrid": SimpleNamespace(
        init_params=hybrid.init_params,
        forward=hybrid.forward,
        loss_fn=hybrid.loss_fn,
        init_decode_cache=hybrid.init_decode_cache,
        decode_step=hybrid.decode_step,
    ),
    "encdec": SimpleNamespace(
        init_params=encdec.init_params,
        forward=encdec.forward,
        loss_fn=encdec.loss_fn,
        init_decode_cache=encdec.init_decode_cache,
        decode_step=encdec.decode_step,
    ),
}

NOT_PORTED = ("xlstm",)


def model_for(cfg: ModelConfig):
    if cfg.family not in _FAMILIES:
        if cfg.family in NOT_PORTED:
            raise NotImplementedError(
                f"model family {cfg.family!r} ({cfg.name}) is not ported to "
                f"repro_torch yet; ported: {sorted(_FAMILIES)}")
        raise KeyError(cfg.family)
    return _FAMILIES[cfg.family]
