"""``soak(seed, ...)`` — the deterministic stress/soak entry point.

Builds a fabric, runs a seeded multi-tenant traffic mix (with optional
fault-injection churn) to completion, runs every invariant checker, and
returns a :class:`SoakResult` whose ``stats`` dict is a pure function of
the arguments: same seed -> byte-identical ``json()``, different seed ->
different traffic.  Used by ``tests/test_stress.py`` and
``benchmarks/arbiter_qos.py``.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import random
from typing import Optional, Sequence

from repro_torch.api.config import FabricConfig
from repro_torch.api.fabric import Fabric
from repro_torch.api.memory import BufferPrep
from repro_torch.core.arbiter import ArbiterStats, ServiceClass
from repro_torch.lint.race import RaceCheckLoop
from repro_torch.testing.invariants import (check_arbiter_consistency,
                                      check_bank_conservation,
                                      check_completion_conservation,
                                      check_crash_consistency,
                                      check_link_conservation,
                                      check_npr_consistency,
                                      check_pinned_resident,
                                      check_stats_accounting,
                                      check_tenant_isolation,
                                      check_tr_id_lifecycle)
from repro_torch.testing.traffic import (FaultInjection, TenantRun, TenantSpec,
                                   schedule_injection)

#: hard ceiling on loop events per soak — a run that trips it is reported
#: as a liveness violation instead of hanging the test suite
MAX_SOAK_EVENTS = 5_000_000

#: events stepped between completion checks: testing every tenant's done
#: flag per event made the driver loop O(tenants x events) — at million-
#: block scale the *harness* dominated the simulation.  Overshooting a
#: chunk is harmless: the post-loop drain runs the same tail events the
#: chunk would have, so final stats are identical.
CHECK_INTERVAL = 2048


def default_tenants() -> list[TenantSpec]:
    """A small adversarial mix: one clean LATENCY serving tenant, one
    fault-storming BULK tenant, one pinned open-loop BULK tenant."""
    return [
        TenantSpec(pd=1, name="serving", service_class=ServiceClass.LATENCY,
                   mode="closed", inflight=2, n_requests=12,
                   size_choices=(4096, 16384), dst_prep=BufferPrep.TOUCHED),
        TenantSpec(pd=2, name="bulk-storm", service_class=ServiceClass.BULK,
                   mode="closed", inflight=4, n_requests=10,
                   size_choices=(65536,), dst_prep=BufferPrep.FAULTING,
                   fresh_dst=True, max_outstanding_blocks=8),
        TenantSpec(pd=3, name="pinned-open", service_class=ServiceClass.BULK,
                   mode="open", arrival_period_us=400.0, n_requests=8,
                   size_choices=(16384,), src_prep=BufferPrep.PINNED,
                   dst_prep=BufferPrep.FAULTING),
    ]


@dataclasses.dataclass
class SoakResult:
    stats: dict                      # deterministic, JSON-able
    violations: list[str]
    runs: list[TenantRun]            # live objects for further inspection
    fabric: Fabric

    @property
    def ok(self) -> bool:
        return not self.violations

    def json(self) -> str:
        """Canonical byte form of the stats (the determinism contract)."""
        return json.dumps(self.stats, sort_keys=True)


def soak(seed: int,
         tenants: Optional[Sequence[TenantSpec]] = None,
         config: Optional[FabricConfig] = None,
         injection: Optional[FaultInjection] = None,
         poll_period_us: float = 200.0,
         max_events: int = MAX_SOAK_EVENTS,
         n_nodes: Optional[int] = None,
         max_duration_us: Optional[float] = None) -> SoakResult:
    """Run one seeded soak to completion and check every invariant.

    ``n_nodes`` is a convenience knob for the scale tiers: it builds a
    default :class:`FabricConfig` of that size (mutually exclusive with
    ``config``).  ``max_duration_us`` bounds *virtual* time the way
    ``max_events`` bounds work — exceeding either is reported as a
    liveness violation rather than hanging the harness.
    """
    if n_nodes is not None and config is not None:
        raise ValueError("pass either config= or n_nodes=, not both")
    # Pause the cyclic collector for the duration of the run: the object
    # graph is dominated by *live* Transfer<->Block cycles, so generational
    # passes walk millions of reachable objects over and over and collect
    # nothing until the fabric is torn down — worth ~15% of wall time at
    # the million-block tier.  Purely host-side: virtual results and the
    # byte-identical stats contract are unaffected.
    gc_was_enabled = gc.isenabled()
    gc.disable()
    try:
        return _soak_body(seed, tenants, config, injection, poll_period_us,
                          max_events, n_nodes, max_duration_us)
    finally:
        if gc_was_enabled:
            gc.enable()


def _soak_body(seed, tenants, config, injection, poll_period_us,
               max_events, n_nodes, max_duration_us) -> SoakResult:
    rng = random.Random(seed)
    fabric = Fabric.build(config or FabricConfig(n_nodes=n_nodes or 2))
    specs = list(tenants) if tenants is not None else default_tenants()
    runs = [TenantRun(fabric, spec, rng, poll_period_us=poll_period_us)
            for spec in specs]
    for r in runs:
        r.start()
    if injection is not None:
        schedule_injection(fabric, runs, injection, rng)

    violations: list[str] = []
    loop = fabric.loop
    start_events = loop.events_processed
    while not all(r.done for r in runs):
        if loop.peek_time() is None:
            violations.append(
                "event loop drained before all tenants completed: "
                + ", ".join(f"{r.spec.label()} {len(r.completions)}/"
                            f"{r.spec.n_requests}"
                            for r in runs if not r.done))
            break
        # run a chunk of events between done-checks (harness overhead
        # stays O(chunks), not O(tenants x events) — and the per-event
        # dispatch stays inside the kernel's tight run_batch loop)
        loop.run_batch(CHECK_INTERVAL)
        if loop.events_processed - start_events > max_events:
            violations.append(
                f"soak exceeded {max_events} events without completing "
                f"— livelock or starvation")
            break
        if max_duration_us is not None and fabric.now > max_duration_us:
            violations.append(
                f"soak exceeded {max_duration_us} us of virtual time "
                f"without completing — livelock or starvation")
            break
    if all(r.done for r in runs):
        # drain the tail (stops once the pumps see every tenant done);
        # on the violation paths above the pumps of unfinished tenants
        # would reschedule forever, so the loop is left as-is there
        fabric.progress()

    # ---- invariants -----------------------------------------------------
    for r in runs:
        violations += check_completion_conservation(
            r.posted_ids, [wc.wr_id for wc in r.completions],
            label=r.spec.label())
    violations += check_pinned_resident(fabric)
    violations += check_crash_consistency(fabric)
    violations += check_arbiter_consistency(fabric)
    violations += check_link_conservation(fabric)
    violations += check_tr_id_lifecycle(fabric)
    violations += check_npr_consistency(fabric)
    violations += check_bank_conservation(fabric)
    violations += check_tenant_isolation(fabric)
    violations += check_stats_accounting(fabric)
    if isinstance(loop, RaceCheckLoop):
        loop.flush()                 # close the final same-time group
        violations += loop.reports

    # ---- deterministic report -------------------------------------------
    stats = {
        "seed": seed,
        "tenants": [r.stats_dict() for r in runs],
        "arbiter": _arbiter_dict(fabric),
        "net": fabric.net_stats().as_dict(),
        "r5": {f"node{nid}": s.tr_id.as_dict()
               for nid, s in sorted(fabric.protocol_stats().items())
               if s.tr_id.allocated},
        "npr": {f"node{nid}": s.npr.as_dict()
                for nid, s in sorted(fabric.protocol_stats().items())
                if s.npr.active},
        "tenancy": {f"node{nid}": s.tenancy.as_dict()
                    for nid, s in sorted(fabric.protocol_stats().items())
                    if s.tenancy.tenants or s.tenancy.bank_stats.binds},
        "makespan_us": round(fabric.now, 6),
        "events": fabric.loop.events_processed,
        "violations": sorted(violations),
    }
    return SoakResult(stats=stats, violations=violations, runs=runs,
                      fabric=fabric)


def _arbiter_dict(fabric: Fabric) -> dict:
    out = {}
    for node in fabric.nodes:
        arb = node.arbiter
        node_key = f"node{node.node_id}"
        out[node_key] = {"total": _stats_fields(arb.stats)}
        for pd in sorted(arb.domain_stats):
            out[node_key][f"pd{pd}"] = _stats_fields(arb.domain_stats[pd])
    return out


def _stats_fields(s: ArbiterStats) -> dict:
    return {f: getattr(s, f)
            for f in (*ArbiterStats.ADDITIVE, "max_queue_depth")}
