"""Family → module dispatch.  Every ported family exposes the same surface:

    init_params(cfg, key, device=None)
    init_decode_cache(cfg, batch, max_len, device=None) -> cache dict
    decode_step(params, cfg, cache, tokens)             -> (logits, cache)

``forward`` / ``loss_fn`` join it when training and prefill are ported.
"""

from __future__ import annotations

from types import SimpleNamespace

from repro_torch.models import decoder
from repro_torch.models.config import ModelConfig

_FAMILIES = {
    "dense": SimpleNamespace(
        init_params=decoder.init_params,
        init_decode_cache=decoder.init_decode_cache,
        decode_step=decoder.decode_step,
    ),
}

NOT_PORTED = ("moe", "mla_moe", "hybrid", "xlstm", "encdec")


def model_for(cfg: ModelConfig):
    if cfg.family not in _FAMILIES:
        if cfg.family in NOT_PORTED:
            raise NotImplementedError(
                f"model family {cfg.family!r} ({cfg.name}) is not ported to "
                f"repro_torch yet; ported: {sorted(_FAMILIES)}")
        raise KeyError(cfg.family)
    return _FAMILIES[cfg.family]
