"""ARM SMMU (MMU-500) model: context banks, fault registers, TLB, HUPCF.

Faithful to §1.3.1.4 / §3.2.1 of the thesis:

* 16 context banks, one per protection domain; each points at one
  :class:`~repro_torch.core.pagetable.PageTable` (its TTBR0).
* Per-bank fault registers: ``FSR`` (TF / PF / MULTI bits), ``FAR`` +
  ``FAR_HIGH`` (faulting 39-bit IOVA), ``FSYNR`` (``WNR`` bit — write =
  destination-buffer fault, read = source-buffer fault).
* ``SCTLR`` controls: ``CFIE`` (raise interrupt), ``CFRE`` (return abort),
  ``HUPCF`` (process transactions *under* an outstanding fault — without it,
  translations of perfectly-resident pages terminate while another fault is
  live, the phenomenon §3.2.1 describes), ``CFCFG`` (Terminate vs Stall).
* Only the **first** fault's details are captured; later faults while FSR is
  non-zero just set ``MULTI`` (the thesis' multiple-simultaneous-faults
  discussion).
* A micro-TLB per bank, invalidated by page-table invalidation hooks (the
  paper's invalidation flow) — a stale TLB entry after THP collapse is
  exactly the surprise fault the mechanism must absorb.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Callable, Optional

from repro_torch.core.addresses import NUM_CONTEXT_BANKS
from repro_torch.core.pagetable import PageState, PageTable

# FSR bits (subset used by the driver)
FSR_TF = 1 << 1       # translation fault
FSR_PF = 1 << 3       # permission fault
FSR_MULTI = 1 << 31   # multiple outstanding faults recorded

# SCTLR bits (subset; §3.2.1 lists the defaults)
SCTLR_M = 1 << 0
SCTLR_TRE = 1 << 1
SCTLR_AFE = 1 << 2
SCTLR_CFRE = 1 << 5
SCTLR_CFIE = 1 << 6
SCTLR_HUPCF = 1 << 8
SCTLR_CFCFG = 1 << 7  # 0 = Terminate, 1 = Stall


class FaultModel(enum.Enum):
    TERMINATE = 0
    STALL = 1


class Access(enum.Enum):
    READ = 0    # RDMA source-buffer translation
    WRITE = 1   # RDMA destination-buffer translation


class Disposition(enum.Enum):
    OK = 0
    TERMINATED = 1   # AXI slave error returned to the master (NACK)
    STALLED = 2      # transaction held; resume/terminate via CBn_RESUME


@dataclasses.dataclass(slots=True)
class TranslationResult:
    disposition: Disposition
    frame: int = -1
    fault_recorded: bool = False    # this translation wrote FSR/FAR/FSYNR
    collateral: bool = False        # terminated only because HUPCF == 0
    tlb_hit: bool = False


@dataclasses.dataclass(slots=True)
class ContextBank:
    index: int
    page_table: Optional[PageTable] = None
    sctlr: int = SCTLR_M | SCTLR_TRE | SCTLR_AFE | SCTLR_CFRE | SCTLR_CFIE
    fsr: int = 0
    far: int = 0          # low 32 bits of faulting IOVA
    far_high: int = 0     # high bits
    fsynr: int = 0        # bit 4 = WNR
    stalled_vpn: int = -1
    # the TLB-invalidation hook attach_domain registered on the bank's
    # page table, kept so detach_domain can unhook it on a bank steal
    invalidation_hook: Optional[Callable[[int], None]] = None

    @property
    def hupcf(self) -> bool:
        return bool(self.sctlr & SCTLR_HUPCF)

    @property
    def fault_model(self) -> FaultModel:
        return FaultModel.STALL if self.sctlr & SCTLR_CFCFG else FaultModel.TERMINATE

    @property
    def fault_active(self) -> bool:
        return self.fsr != 0

    def faulting_iova(self) -> int:
        return (self.far_high << 32) | self.far


@dataclasses.dataclass(slots=True)
class SMMUStats:
    translations: int = 0
    tlb_hits: int = 0
    faults_recorded: int = 0
    multi_faults: int = 0
    collateral_terminations: int = 0
    interrupts: int = 0
    tlb_invalidations: int = 0


class SMMU:
    """One node's System MMU with ``NUM_CONTEXT_BANKS`` context banks.

    ``interrupt_handler`` is the driver's ``arm_smmu_context_fault``; the
    simulator wires it to :class:`repro_torch.core.driver` logic with the proper
    latencies.  It is invoked with the bank index whenever a fault is
    recorded and CFIE is set.
    """

    def __init__(self, node_id: int = 0,
                 interrupt_handler: Optional[Callable[[int], None]] = None):
        self.node_id = node_id
        self.banks = [ContextBank(i) for i in range(NUM_CONTEXT_BANKS)]
        self.interrupt_handler = interrupt_handler
        self.stats = SMMUStats()
        # micro-TLB keyed by packed ``(bank << 32) | vpn`` ints — int
        # hashing beats tuple hashing on the per-page translate path, and
        # vpns are 27-bit (39-bit IOVA space), so packing never collides
        self._tlb: dict[int, int] = {}

    # -------------------------------------------------------------- config
    def attach_domain(self, bank_index: int, page_table: PageTable,
                      hupcf: bool = True,
                      fault_model: FaultModel = FaultModel.TERMINATE) -> None:
        bank = self.banks[bank_index]
        bank.page_table = page_table
        if hupcf:
            bank.sctlr |= SCTLR_HUPCF
        else:
            bank.sctlr &= ~SCTLR_HUPCF
        if fault_model is FaultModel.STALL:
            bank.sctlr |= SCTLR_CFCFG
        else:
            bank.sctlr &= ~SCTLR_CFCFG
        hook = lambda vpn, b=bank_index: self.tlb_invalidate(b, vpn)
        page_table.invalidation_hooks.append(hook)
        bank.invalidation_hook = hook

    def detach_domain(self, bank_index: int) -> None:
        """Unbind a bank (bank steal / close_domain): full TLB shootdown,
        fault registers cleared, invalidation hook unhooked."""
        bank = self.banks[bank_index]
        if bank.page_table is not None and bank.invalidation_hook is not None:
            try:
                bank.page_table.invalidation_hooks.remove(
                    bank.invalidation_hook)
            except ValueError:
                pass
        bank.invalidation_hook = None
        self.tlb_invalidate_all(bank_index)
        self.clear_fault(bank_index)
        bank.stalled_vpn = -1
        bank.page_table = None

    # ----------------------------------------------------------------- TLB
    def tlb_invalidate(self, bank_index: int, vpn: int) -> None:
        if self._tlb.pop((bank_index << 32) | vpn, None) is not None:
            self.stats.tlb_invalidations += 1

    def tlb_invalidate_all(self, bank_index: int) -> None:
        for key in [k for k in self._tlb if k >> 32 == bank_index]:
            del self._tlb[key]
            self.stats.tlb_invalidations += 1

    # ----------------------------------------------------------- translate
    def translate(self, bank_index: int, vpn: int,
                  access: Access) -> TranslationResult:
        """Full translation record (driver-facing callers, tests)."""
        bank = self.banks[bank_index]
        pt = bank.page_table
        assert pt is not None, f"context bank {bank_index} not attached"
        self.stats.translations += 1

        # Hit-under-previous-fault: if a fault is outstanding and HUPCF is
        # clear, *every* subsequent transaction terminates, resident or not.
        if bank.fsr and not bank.sctlr & SCTLR_HUPCF:
            self.stats.collateral_terminations += 1
            return TranslationResult(Disposition.TERMINATED, collateral=True)

        cached = self._tlb.get((bank_index << 32) | vpn)
        if cached is not None:
            self.stats.tlb_hits += 1
            return TranslationResult(Disposition.OK, frame=cached, tlb_hit=True)

        pte = pt.lookup(vpn)
        if pte.state == PageState.RESIDENT and (access is Access.READ
                                                or pte.writable):
            self._tlb[(bank_index << 32) | vpn] = pte.frame
            return TranslationResult(Disposition.OK, frame=pte.frame)

        disp, recorded = self._record_fault(bank, vpn, access, pte)
        return TranslationResult(disp, fault_recorded=recorded)

    def translate_disposition(self, bank_index: int, vpn: int,
                              access: Access) -> Disposition:
        """Allocation-free variant of :meth:`translate` for the per-page
        datapath (PLDMA source reads, destination arrivals): identical
        state transitions and stats, but returns only the
        :class:`Disposition` — the one field those paths consult — so
        the resident-page common case builds no result record.
        """
        bank = self.banks[bank_index]
        pt = bank.page_table
        assert pt is not None, f"context bank {bank_index} not attached"
        st = self.stats
        st.translations += 1
        if bank.fsr and not bank.sctlr & SCTLR_HUPCF:
            st.collateral_terminations += 1
            return Disposition.TERMINATED
        if (bank_index << 32) | vpn in self._tlb:
            st.tlb_hits += 1
            return Disposition.OK
        pte = pt.lookup(vpn)
        if pte.state == PageState.RESIDENT and (access is Access.READ
                                                or pte.writable):
            self._tlb[(bank_index << 32) | vpn] = pte.frame
            return Disposition.OK
        return self._record_fault(bank, vpn, access, pte)[0]

    def _record_fault(self, bank: ContextBank, vpn: int, access: Access,
                      pte) -> tuple[Disposition, bool]:
        """Shared fault path of both translate variants: FSR/FAR/FSYNR
        capture (first fault only), MULTI accounting, interrupt, and the
        Terminate-vs-Stall disposition.  Returns ``(disposition,
        fault_recorded)``."""
        permission = (pte.state == PageState.RESIDENT)  # mapped but not writable
        recorded = False
        if not bank.fsr:
            bank.fsr = FSR_PF if permission else FSR_TF
            iova = vpn << 12
            bank.far = iova & 0xFFFF_FFFF
            bank.far_high = (iova >> 32) & 0xFFFF
            bank.fsynr = (1 << 4) if access is Access.WRITE else 0
            recorded = True
            self.stats.faults_recorded += 1
            if bank.sctlr & SCTLR_CFIE and self.interrupt_handler is not None:
                self.stats.interrupts += 1
                self.interrupt_handler(bank.index)
        else:
            bank.fsr |= FSR_MULTI
            self.stats.multi_faults += 1

        if bank.fault_model is FaultModel.STALL:
            bank.stalled_vpn = vpn
            return Disposition.STALLED, recorded
        return Disposition.TERMINATED, recorded

    # ------------------------------------------------------------ driver IF
    def read_fault_record(self, bank_index: int) -> tuple[int, int, bool]:
        """Driver reads (iova, fsynr_wnr, is_translation_fault) of bank."""
        bank = self.banks[bank_index]
        return (bank.faulting_iova(), (bank.fsynr >> 4) & 1,
                bool(bank.fsr & FSR_TF))

    def clear_fault(self, bank_index: int) -> None:
        bank = self.banks[bank_index]
        bank.fsr = 0
        bank.far = bank.far_high = bank.fsynr = 0

    def resume_stalled(self, bank_index: int, retry: bool = True) -> Disposition:
        """CBn_RESUME write: retry or terminate a stalled transaction."""
        bank = self.banks[bank_index]
        vpn = bank.stalled_vpn
        bank.stalled_vpn = -1
        self.clear_fault(bank_index)
        if not retry or vpn < 0:
            return Disposition.TERMINATED
        res = self.translate(bank_index,
                             vpn, Access.WRITE if bank.fsynr else Access.READ)
        return res.disposition
