"""Calibrated cost model for the discrete-event simulator.

All times in **microseconds**, calibrated against the thesis measurements:

* Table 4.1 — per-buffer overhead of ``mmap/munmap/pin/unpin/touch`` for
  16 B … 64 KB buffers (measured on the Zynq UltraScale+ A53 @ Linux 4.9);
* "The round-trip latency of a remote DMA write transfer that experiences
  zero page faults ... is 4 µs for 16 Bytes" (Chapter 4);
* 100 ns hop-to-hop latency, 10 Gb/s HSS links (Section 1.3.1.2 / Chapter 4);
* 1 ms default R5 retransmission timeout (best of {25, 2.5, 1} ms).

The OS-call table is kept verbatim and interpolated in *pages*, so
``benchmarks/table_4_1.py`` reproduces the table exactly and every other
figure inherits consistent constants.
"""

from __future__ import annotations

import bisect
import dataclasses

from repro_torch.core.addresses import MTU, PAGE_SIZE

# Table 4.1 (time in usec) — sizes in bytes, per single buffer.
TABLE_4_1_SIZES = (16, 64, 256, 1024, 4096, 16384, 32768, 65536)
TABLE_4_1 = {
    "mmap":   (2, 2, 2, 2, 2, 2, 2, 2),
    "munmap": (6, 6, 6, 6, 7, 10, 12, 19),
    "pin":    (6, 6, 6, 6, 6, 15, 27, 49),
    "unpin":  (2, 2, 2, 2, 2, 5, 8, 14),
    "touch":  (3, 3, 3, 3, 3, 10, 19, 40),
}


def _interp(op: str, nbytes: int) -> float:
    """Piecewise-linear interpolation of Table 4.1 in buffer size."""
    sizes = TABLE_4_1_SIZES
    vals = TABLE_4_1[op]
    if nbytes <= sizes[0]:
        return float(vals[0])
    if nbytes >= sizes[-1]:
        # extrapolate linearly per extra page beyond 64 KB
        per_page = (vals[-1] - vals[-2]) / ((sizes[-1] - sizes[-2]) / PAGE_SIZE)
        extra_pages = (nbytes - sizes[-1]) / PAGE_SIZE
        return float(vals[-1]) + per_page * extra_pages
    i = bisect.bisect_right(sizes, nbytes)
    lo_s, hi_s = sizes[i - 1], sizes[i]
    lo_v, hi_v = vals[i - 1], vals[i]
    frac = (nbytes - lo_s) / (hi_s - lo_s)
    return lo_v + frac * (hi_v - lo_v)


@dataclasses.dataclass(frozen=True)
class CostModel:
    """Microsecond-scale cost constants for the simulator.

    The per-event constants below are chosen so the end-to-end paths match
    the thesis numbers (see ``tests/test_costmodel.py`` and
    ``benchmarks/fig_4_*.py``): ideal 16 B RTT = 4 µs; destination-fault
    Touch-Ahead/Touch-A-Page ratios ≈ 1.7×/1.2×/1.2× at 16/32/64 KB;
    source-fault ratios ≈ 3.9×/3.9×/4.7×; driver latency µs-scale with the
    get_user_pages (Touch-Ahead) path costing more in-kernel time.
    """

    # --- network / PLDMA -------------------------------------------------
    hop_latency_us: float = 0.1                 # 100 ns per hop
    link_gbps: float = 10.0                     # HSS link
    dma_setup_us: float = 2.64                  # A53 -> TCM/mailbox + R5 init
    #   (calibrated so the zero-fault 16 B remote write lands on the
    #    thesis' measured 4 us round trip)
    per_block_r5_us: float = 0.35               # R5 segmentation/monitor per block
    ack_us: float = 0.3                         # ACK generation + mailbox write
    nack_us: float = 0.3                        # AXI slave-error propagation
    smmu_translate_us: float = 0.02             # TBU hit, ~2 clocks
    completion_poll_us: float = 0.5             # user polls PLDMA status reg

    # --- SMMU fault path (driver side; Fig 4.7 scale) ---------------------
    interrupt_us: float = 1.0                   # context-fault interrupt entry
    handler_regs_us: float = 0.6                # FSR/FAR/FSYNR reads + decode
    tasklet_latency_us: float = 1.2             # schedule -> run delay
    fifo_read64_us: float = 0.2                 # one AXI-lite 64-bit read
    driver_bookkeep_us: float = 0.6             # last-2 dedup check, state
    netlink_send_us: float = 1.1                # kernel -> user nl_send
    gup_base_us: float = 2.2                    # get_user_pages entry/exit
    gup_per_page_us: float = 2.6                # in-kernel page-in per page

    # --- user-space library (Touch-A-Page path) ---------------------------
    wakeup_us: float = 4.0                      # nl recv + ctx switch to thread
    touch_page_us: float = 2.8                  # 1-page touch (CPU MMU minor PF)
    pckzer_to_mbox_us: float = 1.0              # RAPF via packetizer -> mailbox
    sigsegv_recover_us: float = 9.0             # stale-page SIGSEGV handler

    # --- R5 scheduler ------------------------------------------------------
    timeout_us: float = 1000.0                  # retransmission timeout (1 ms)
    mailbox_poll_us: float = 0.4                # R5 mailbox decode
    retransmit_setup_us: float = 0.5            # R5 re-initiates a block

    # --- major faults (future-work knob in the paper; off by default) ------
    major_fault_extra_us: float = 150.0         # NVMe-class page-in

    # --- tenancy control plane (context-bank overcommit) -------------------
    bank_shootdown_us: float = 3.0              # tlb_invalidate_all broadcast
    bank_rebind_us: float = 1.5                 # TTBR0/SCTLR rewrite + sync

    # --- NP-RDMA backend (repro.npr; arXiv 2310.11062 scale) ---------------
    mtt_fill_us: float = 0.3                    # host installs one MTT entry
    npr_abort_ctrl_us: float = 0.3              # abort control message build
    npr_fixup_base_us: float = 1.5              # host fix-up handler entry
    pool_copy_page_us: float = 0.9              # pool frame -> app page copy
    pool_refill_us: float = 6.0                 # re-register a retired batch

    # ------------------------------------------------------------------ OS
    def mmap_us(self, nbytes: int) -> float:
        return _interp("mmap", nbytes)

    def munmap_us(self, nbytes: int) -> float:
        return _interp("munmap", nbytes)

    def pin_us(self, nbytes: int) -> float:
        return _interp("pin", nbytes)

    def unpin_us(self, nbytes: int) -> float:
        return _interp("unpin", nbytes)

    def touch_us(self, nbytes: int) -> float:
        """User-space touch of a whole buffer (one byte per page)."""
        return _interp("touch", nbytes)

    # ------------------------------------------------------------- network
    def packet_wire_us(self, nbytes: int = MTU) -> float:
        """Serialization time of one packet on the HSS link."""
        return (nbytes * 8) / (self.link_gbps * 1e3)  # Gb/s -> bits/us

    def gup_us(self, n_pages: int) -> float:
        return self.gup_base_us + self.gup_per_page_us * n_pages


DEFAULT_COST_MODEL = CostModel()


def cost_model_with_timeout(timeout_us: float) -> CostModel:
    return dataclasses.replace(DEFAULT_COST_MODEL, timeout_us=timeout_us)
