"""Deterministic fabric stress/soak harness.

Everything the example-driven tests could not prove lives here: seeded
multi-tenant traffic generation (:mod:`repro_torch.testing.traffic`), invariant
checkers (:mod:`repro_torch.testing.invariants`) and the
:func:`~repro_torch.testing.soak.soak` entry point shared by the stress tests
and ``benchmarks/arbiter_qos.py``.

Determinism contract: two ``soak(seed)`` runs with the same seed produce
**byte-identical** stats dicts (``json.dumps(..., sort_keys=True)``), and
different seeds produce different traffic — guarded by
``tests/test_stress.py``, so the event loop stays free of wall-clock and
iteration-order nondeterminism.
"""

from repro_torch.testing.invariants import (check_arbiter_consistency,
                                      check_bank_conservation,
                                      check_completion_conservation,
                                      check_crash_consistency,
                                      check_link_conservation,
                                      check_pinned_resident,
                                      check_route_sanity,
                                      check_tenant_isolation,
                                      check_stats_accounting,
                                      check_tr_id_lifecycle,
                                      check_vmem_frame_conservation,
                                      check_vmem_pins)
from repro_torch.testing.soak import SoakResult, soak
from repro_torch.testing.traffic import FaultInjection, TenantSpec, scale_mix

__all__ = [
    "FaultInjection", "SoakResult", "TenantSpec",
    "check_arbiter_consistency", "check_bank_conservation",
    "check_completion_conservation", "check_crash_consistency",
    "check_link_conservation", "check_pinned_resident",
    "check_route_sanity", "check_tenant_isolation",
    "check_stats_accounting", "check_tr_id_lifecycle",
    "check_vmem_frame_conservation",
    "check_vmem_pins", "scale_mix", "soak",
]
