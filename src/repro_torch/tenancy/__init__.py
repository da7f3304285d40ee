"""Tenancy control plane: virtualizing the fabric's fixed resources.

The reference's ``tenancy`` package, names and submodules unchanged:
``BankManager`` (context-bank overcommit with LRU bank stealing),
``SRQ`` / ``QPMux`` (shared receive entries and queue-pair muxing),
``SLOClass`` (GOLD/SILVER/BEST_EFFORT tiers) and ``TenancyManager`` (the
per-node composition, surfaced through ``Fabric.protocol_stats()``).

Import-free on purpose: ``tenancy.banks`` imports ``repro_torch.core``,
whose node module imports ``TenancyManager`` from here, so an ``__init__``
that imported its submodules eagerly would make ``import
repro_torch.tenancy`` as a first import fail (it does in the reference).
The public names resolve on first use instead (PEP 562).
"""

import importlib

_EXPORTS = {
    "BankManager": "banks", "BankStats": "banks", "Binding": "banks",
    "NoBankAvailable": "banks", "TenancyManager": "manager",
    "QPMux": "qp", "SRQ": "qp", "SRQStats": "qp",
    "SLOClass": "slo", "coerce_slo": "slo",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(
        f"{__name__}.{_EXPORTS[name]}"), name)
    globals()[name] = value
    return value
