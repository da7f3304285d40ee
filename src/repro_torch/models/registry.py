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

from repro_torch.configs import all_configs
from repro_torch.models import decoder, encdec, hybrid, xlstm_model
from repro_torch.models.config import ModelConfig

API = ("init_params", "forward", "loss_fn", "init_decode_cache",
       "decode_step")


def _api(module) -> SimpleNamespace:
    return SimpleNamespace(**{name: getattr(module, name) for name in API})


_DECODER = _api(decoder)

_FAMILIES = {
    "dense": _DECODER,
    "moe": _DECODER,
    "mla_moe": _DECODER,
    "hybrid": _api(hybrid),
    "encdec": _api(encdec),
    "xlstm": _api(xlstm_model),
}

# families of the carried configs (``configs.ARCH_IDS``) that no module
# serves: empty since xLSTM, and the tests hold it so
NOT_PORTED = tuple(sorted({c.family for c in all_configs().values()}
                          - set(_FAMILIES)))


def model_for(cfg: ModelConfig):
    if cfg.family not in _FAMILIES:
        raise KeyError(cfg.family)
    return _FAMILIES[cfg.family]
