"""Protocol state-machine specs — the single source of truth.

Four lifecycles from the paper's fault-handling protocol are written
down here as plain data.  ``repro_torch.lint.conformance`` extracts the
*implemented* transitions/mutators from the source AST and fails on any
site outside these tables; ``repro_torch.lint.model`` exhaustively walks a
product state machine over the same tables and fails on deadlocks, lost
completions, and dead spec rows.  The README's lifecycle tables are
prose renderings of exactly these structures — when the protocol
changes, change it HERE first and let the linter point at every stale
site.

The four specs:

``BLOCK``
    Per-block transfer lifecycle (``repro_torch.core.node.BlockState``): the
    R5 scheduler dispatches PENDING blocks, faults park them in
    PAUSED_SRC (local SMMU miss) or PAUSED_DST (responder NACK /
    NP-RDMA pool stall), retries resume them, completion/failure drains
    them to DONE.  DONE is terminal — a block never un-completes.
``WR``
    Work-request → work-completion lifecycle: a posted WR resolves
    exactly once, to success or to exactly one of the paper's three
    error statuses (retry budget exhausted, local machine flush, remote
    machine death).
``TR_ID``
    Transaction-id (tr_id) resource lifecycle on ``R5Scheduler``: ids
    come from a bump allocator (FRESH) or the free list, are OWNED
    while a transfer holds them, become LEASED when the owner's machine
    crashes (held back for the reuse-ambiguity window), and return to
    FREE with a bumped generation.
``BANK``
    Context-bank bind/steal/release lifecycle on
    ``repro_torch.tenancy.banks.BankManager``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, FrozenSet, Mapping, Tuple


@dataclasses.dataclass(frozen=True)
class LifecycleSpec:
    """One protocol lifecycle: named states + allowed transitions.

    ``transitions`` maps ``(from_state, to_state) -> reason`` — the
    reason string is documentation rendered into the README tables and
    the conformance error messages.
    """

    name: str
    states: Tuple[str, ...]
    initial: str
    terminal: FrozenSet[str]
    transitions: Mapping[Tuple[str, str], str]

    def allows(self, src: str, dst: str) -> bool:
        return (src, dst) in self.transitions


# --------------------------------------------------------------------- BLOCK
BLOCK = LifecycleSpec(
    name="block",
    states=("PENDING", "IN_FLIGHT", "PAUSED_SRC", "PAUSED_DST", "DONE"),
    initial="PENDING",
    terminal=frozenset({"DONE"}),
    transitions={
        ("PENDING", "IN_FLIGHT"):
            "R5 scheduler dispatches the block (WQE issued)",
        ("IN_FLIGHT", "IN_FLIGHT"):
            "retry re-issues an already-dispatched block (new round_id)",
        ("PAUSED_SRC", "IN_FLIGHT"):
            "local page-fault resolved; fixup path re-issues",
        ("PAUSED_DST", "IN_FLIGHT"):
            "responder-side fault cleared; NACK retry re-issues",
        ("IN_FLIGHT", "PAUSED_SRC"):
            "local SMMU miss mid-transfer parks the block",
        ("IN_FLIGHT", "PAUSED_DST"):
            "responder NACK (dst fault) or NP-RDMA pool stall",
        ("PAUSED_SRC", "PAUSED_DST"):
            "responder NACK lands while the source fixup is pending",
        ("IN_FLIGHT", "DONE"):
            "ACK received, or transfer failed while block in flight",
        ("PENDING", "DONE"):
            "transfer fails before the block was ever dispatched",
        ("PAUSED_SRC", "DONE"):
            "transfer fails (budget/crash) while parked on a src fault",
        ("PAUSED_DST", "DONE"):
            "transfer fails (budget/crash) while parked on a dst fault",
    },
)


# ----------------------------------------------------------------------- WR
#: WC status wire strings (Transfer.failed_status uses the raw strings;
#: repro_torch.api.completion.WCStatus mirrors them as enum values)
WC_SUCCESS = "success"
WC_ERROR_STATUSES = ("retry_exc_err", "wr_flush_err", "remote_op_err")

WR = LifecycleSpec(
    name="wr",
    states=("POSTED", "SUCCESS", "RETRY_EXC_ERR", "WR_FLUSH_ERR",
            "REMOTE_OP_ERR"),
    initial="POSTED",
    terminal=frozenset({"SUCCESS", "RETRY_EXC_ERR", "WR_FLUSH_ERR",
                        "REMOTE_OP_ERR"}),
    transitions={
        ("POSTED", "SUCCESS"):
            "all blocks ACKed; completion posted to the CQ",
        ("POSTED", "RETRY_EXC_ERR"):
            "per-transfer retry budget exhausted (paper §fault-storms)",
        ("POSTED", "WR_FLUSH_ERR"):
            "local machine failed; outstanding WRs flushed",
        ("POSTED", "REMOTE_OP_ERR"):
            "remote machine declared dead (timeout/partition)",
    },
)


# -------------------------------------------------------------------- TR_ID
TR_ID = LifecycleSpec(
    name="tr_id",
    states=("FRESH", "OWNED", "LEASED", "FREE"),
    initial="FRESH",
    terminal=frozenset(),          # ids cycle forever
    transitions={
        ("FRESH", "OWNED"):
            "bump allocator hands out a never-used id",
        ("FREE", "OWNED"):
            "free-list pop recycles an id (generation bumped)",
        ("OWNED", "FREE"):
            "transfer completed/failed locally; id returned",
        ("OWNED", "LEASED"):
            "owner machine crashed; id held for the lease window",
        ("LEASED", "FREE"):
            "lease expired with no late responder traffic",
    },
)

#: R5Scheduler fields that embody tr_id state, and the methods allowed
#: to mutate each (``__init__`` is implicitly allowed everywhere).
#: conformance.check_mutators fails on any OTHER method touching these.
TR_ID_FIELDS: Dict[str, FrozenSet[str]] = {
    "pending": frozenset({"_launch_next", "_fail_block", "on_ack",
                          "_reclaim_leases"}),
    "_free": frozenset({"_alloc_tr_id", "_free_tr_id"}),
    "_fresh_next": frozenset({"_alloc_tr_id"}),
    "_gen": frozenset({"_alloc_tr_id"}),
    "_starved": frozenset({"_launch_next", "on_ack", "fail_transfer",
                           "on_local_crash"}),
}

#: BankManager fields embodying bank state → allowed mutator methods.
BANK_FIELDS: Dict[str, FrozenSet[str]] = {
    "_domains": frozenset({"register", "release"}),
    "_bank_owner": frozenset({"release", "_attach", "bind"}),
    "bank": frozenset({"_attach", "bind"}),    # _Domain.bank slot
}

BANK = LifecycleSpec(
    name="bank",
    states=("UNBOUND", "BOUND"),
    initial="UNBOUND",
    terminal=frozenset(),
    transitions={
        ("UNBOUND", "BOUND"):
            "bind()/_attach(): free bank claimed or victim stolen",
        ("BOUND", "BOUND"):
            "rebind after shootdown (steal immunity window respected)",
        ("BOUND", "UNBOUND"):
            "release(): domain closed, bank returned to the free pool",
    },
)

#: every lifecycle, for spec round-trip tests and the CLI summary
ALL_SPECS: Tuple[LifecycleSpec, ...] = (BLOCK, WR, TR_ID, BANK)


# ----------------------------------------------------------- stats coverage
#: *Stats counter fields that no invariant checker reads, each with the
#: reason it is telemetry-only.  ``stats_coverage`` fails on (a) a
#: counter neither checked nor listed here, (b) a row naming a field
#: that no longer exists, (c) a row for a field an invariant DOES read
#: (stale exemption).  Format: {ClassName: {field: reason}}; the field
#: ``"*"`` exempts every not-otherwise-checked counter of the class
#: with one reason (for pure-telemetry classes).
STATS_EXEMPT: Dict[str, Dict[str, str]] = {
    "TrIdStats": {
        "exhausted_posts":
            "post-refusal event count; asserted by tests/test_tr_id wraps",
        "stale_rapf_drops":
            "incarnation-safety event count; asserted by targeted tests",
        "stale_fifo_entries":
            "incarnation-safety event count; asserted by targeted tests",
        "stale_npr_aborts":
            "incarnation-safety event count; asserted by targeted tests",
        "lease_reclaims":
            "crash-path event count; asserted by the crash-fault tests",
    },
    "CQStats": {
        "rejected_posts":
            "backpressure event count; no conservation identity",
        "deadline_expiries":
            "wait()-timeout event count; no conservation identity",
    },
    "SRQStats": {
        "rejected": "backpressure event count; no conservation identity",
    },
    "BankStats": {
        "hits": "bind-lookup fast-path count; no conservation identity",
    },
    "FIFOStats": {
        "dedup_skips":
            "hardware consecutive-dedup event count; tests/test_fault_fifo",
        "overflow_drops":
            "hardware overflow event count; tests/test_fault_fifo",
    },
    "FabricStats": {
        "elapsed_us": "snapshot timestamp, not a counter",
    },
    "NPRStats": {
        "*": "NP-RDMA datapath event telemetry; the safety counter "
             "(stale_completions) and pool/MTT capacities ARE checked — "
             "the rest is asserted by tests/test_npr*",
    },
    "SMMUStats": {
        "*": "TLB/fault event telemetry; tlb_hits<=translations IS "
             "checked — the rest is asserted by tests/test_fault*",
    },
    "PageTableStats": {
        "*": "page-walk churn telemetry; pin conservation IS checked — "
             "the rest is asserted by tests/test_pagetable*",
    },
    "TransferStats": {
        "*": "per-transfer sample record (one per WR), aggregated by the "
             "benchmarks; fabric-level conservation is checked on the "
             "node/arbiter/tr_id counters instead",
    },
    "PagingStats": {
        "*": "vmem pager telemetry outside the fabric invariant surface; "
             "asserted by tests/test_vmem* and tests/test_paging*",
    },
    "EngineStats": {
        "*": "serving-layer telemetry outside the fabric invariant "
             "surface; asserted by tests/test_serving*",
    },
}
