"""The typed error hierarchy — one dependency-free leaf module.

Every layer of the reproduction raises *typed* errors rooted here, so
callers can catch semantically (``except FabricError``) instead of
pattern-matching message strings, and so the ``repro.lint`` typed-error
rule can enforce the discipline mechanically: no ``raise ValueError`` /
``raise RuntimeError`` in ``repro.api`` or ``repro.tenancy``.

The module sits *below* every other ``repro`` package (it imports
nothing), which is what lets ``repro.tenancy`` raise the same hierarchy
``repro.core`` defines without a layering cycle (``core.node`` imports
``tenancy``, so tenancy could never import the classes back out of it).
``repro.core.node`` re-exports the classes unchanged for back-compat.

Subclassing contract: :class:`FabricError` IS a ``ValueError`` and
:class:`LivelockError` IS a ``RuntimeError`` — the builtins these typed
errors replaced — so pre-existing ``except ValueError`` /
``pytest.raises(ValueError)`` call sites keep working unchanged.
"""

from __future__ import annotations

__all__ = [
    "AdmissionError", "BankCollision", "ConfigError", "DomainClosed",
    "DomainExists", "FabricError", "LivelockError", "NodeDown",
]


class FabricError(ValueError):
    """A fabric-level configuration or wiring error (e.g. two live
    protection domains colliding on one SMMU context bank)."""


class ConfigError(FabricError):
    """An invalid knob value caught at construction time —
    :class:`~repro.api.config.FabricConfig`,
    :class:`~repro.api.policy.FaultPolicy`, CQ/SRQ bounds, SLO
    spellings.  Raised before any simulated work starts."""


class DomainExists(FabricError):
    """``open_domain``/``create_domain`` for a pd that is already live."""


class BankCollision(FabricError):
    """Two live protection domains map to one SMMU context bank — only
    raised when bank overcommit is disabled
    (``FabricConfig(bank_overcommit=False)``); with the tenancy control
    plane enabled the BankManager multiplexes the banks instead."""


class DomainClosed(FabricError):
    """A verb was posted against a domain after ``Fabric.close_domain``."""


class NodeDown(FabricError):
    """A verb was posted *from* a crashed node (``Node.crash``).

    Only the posting side is checked: posting *toward* a dead peer is
    allowed and surfaces asynchronously as an error completion
    (``WCStatus.REMOTE_OP_ERR``), matching real RDMA semantics where the
    initiator cannot know the target died until retries exhaust."""


class AdmissionError(FabricError):
    """A node refused to admit one more tenant (``tenants_per_node`` or
    the GOLD-bank ceiling).  The fabric-level verbs pre-check admission
    and surface :class:`~repro.api.completion.TenantQuotaExceeded`
    instead; this is the ``TenancyManager``-level backstop for direct
    ``Node``/manager use."""


class LivelockError(RuntimeError):
    """An event-budget backstop tripped: the loop kept producing events
    without the awaited condition becoming true (a zero-delay cycle or a
    starved completion).  Subclasses ``RuntimeError`` because that is
    what the budget checks raised before this class existed."""
