"""SMMU context-bank virtualization: overcommit 16 banks across N domains.

The hardware (and the seed reproduction) pins one protection domain to
``pd % 16`` forever — the 17th tenant on a node is simply rejected.  The
``BankManager`` breaks that ceiling the way an SMMU driver would: virtual
domains *bind* to a physical context bank on demand, and when every bank
is occupied a cold domain's bank is *stolen* (LRU), which costs a full
``tlb_invalidate_all`` shootdown plus a page-table rebind before the new
domain can translate.  The manager is pure bookkeeping — deciding who is
bound where and who gets evicted — while the ``Node`` executes the
detach/attach against the SMMU model and charges the ``CostModel``
shootdown/rebind time, so determinism and cost accounting stay in the
datapath where the rest of the simulator keeps them.

Binding policy (deterministic):

1. already bound -> hit (LRU touch);
2. prefer the legacy ``pd % capacity`` bank when it is free, so any
   workload that fits in 16 banks binds *exactly* like the seed did;
3. otherwise the lowest-indexed free bank;
4. otherwise steal the least-recently-used bank whose domain is not
   steal-immune (GOLD) and whose bank has no fault in flight;
5. otherwise (all candidates immune) steal the LRU immune bank anyway —
   forward progress beats immunity — counting ``immune_steals``;
6. if every bank has a fault in flight, raise ``NoBankAvailable``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, Optional

from repro_torch.core import addresses as A
from repro_torch.errors import DomainExists

__all__ = ["BankManager", "BankStats", "Binding", "NoBankAvailable"]


class NoBankAvailable(RuntimeError):
    """Every context bank has a fault in flight; binding must wait."""


@dataclass
class BankStats:
    """Per-node context-bank virtualization counters (ADDITIVE)."""

    binds: int = 0          #: bindings established (fresh or after steal)
    hits: int = 0           #: lookups served by an existing binding
    steals: int = 0         #: binds that evicted another domain's bank
    shootdowns: int = 0     #: tlb_invalidate_all shootdowns executed
    immune_steals: int = 0  #: steals that had to evict a GOLD domain
    rebinds: int = 0        #: domains re-bound after losing their bank

    def as_dict(self) -> Dict[str, int]:
        return {"binds": self.binds, "hits": self.hits,
                "steals": self.steals, "shootdowns": self.shootdowns,
                "immune_steals": self.immune_steals,
                "rebinds": self.rebinds}


@dataclass(frozen=True)
class Binding:
    """Outcome of ``BankManager.bind``: where, and who was evicted."""

    bank: int
    stolen: bool = False
    victim_pd: Optional[int] = None
    hit: bool = False           #: binding already existed (no attach needed)


@dataclass
class _Domain:
    pd: int
    steal_immune: bool = False
    bank: Optional[int] = None
    last_use: int = 0
    ever_bound: bool = False


class BankManager:
    """Per-node binding table: virtual domains over physical banks."""

    def __init__(self, capacity: int = A.NUM_CONTEXT_BANKS) -> None:
        self.capacity = int(capacity)
        self.stats = BankStats()
        self._domains: Dict[int, _Domain] = {}        # pd -> domain
        self._bank_owner: Dict[int, int] = {}          # bank -> pd
        self._tick = 0

    # ------------------------------------------------------------------
    # registration / teardown
    # ------------------------------------------------------------------
    def register(self, pd: int, steal_immune: bool = False) -> None:
        if pd in self._domains:
            raise DomainExists(f"pd {pd} already registered")
        self._domains[pd] = _Domain(pd=pd, steal_immune=steal_immune)

    def release(self, pd: int) -> Optional[int]:
        """Forget ``pd`` entirely; returns the bank it held, if any."""
        dom = self._domains.pop(pd, None)
        if dom is None:
            return None
        if dom.bank is not None:
            del self._bank_owner[dom.bank]
        return dom.bank

    # ------------------------------------------------------------------
    # lookups (no side effects beyond LRU)
    # ------------------------------------------------------------------
    def bank_of(self, pd: int) -> Optional[int]:
        dom = self._domains.get(pd)
        return None if dom is None else dom.bank

    def pd_for_bank(self, bank: int) -> Optional[int]:
        return self._bank_owner.get(bank)

    def bound_count(self) -> int:
        return len(self._bank_owner)

    def registered(self, pd: int) -> bool:
        return pd in self._domains

    def is_immune(self, pd: int) -> bool:
        dom = self._domains.get(pd)
        return bool(dom and dom.steal_immune)

    def bindings(self) -> Dict[int, int]:
        """Snapshot ``{bank: pd}`` for invariant checks."""
        return dict(self._bank_owner)

    # ------------------------------------------------------------------
    # binding
    # ------------------------------------------------------------------
    def touch(self, pd: int) -> None:
        dom = self._domains[pd]
        self._tick += 1
        dom.last_use = self._tick

    def domain_handle(self, pd: int) -> Optional[_Domain]:
        """The mutable per-domain record, for caller-side caching.

        The node's per-page hot path holds on to this handle: while
        ``handle.bank`` is not None the binding is live, and a steal
        nulls the victim's ``bank`` in place — so a cached handle can
        never serve a stale bank.  Pair with :meth:`note_hit`.
        """
        return self._domains.get(pd)

    def note_hit(self, dom: _Domain) -> None:
        """Hit accounting for a caller-cached live binding: exactly what
        :meth:`bind` does for an already-bound domain (LRU touch + hit
        counter), minus the dict probe and the Binding allocation."""
        self.stats.hits += 1
        self._tick += 1
        dom.last_use = self._tick

    def bind(self, pd: int,
             fault_active: Callable[[int], bool] = lambda bank: False,
             ) -> Binding:
        """Ensure ``pd`` holds a bank; may steal one.  LRU-touches ``pd``.

        ``fault_active(bank)`` marks banks the SMMU is mid-fault on —
        those must not be ripped out from under the fault FIFO.
        """
        dom = self._domains[pd]
        self.touch(pd)
        if dom.bank is not None:
            self.stats.hits += 1
            return Binding(bank=dom.bank, hit=True)

        bank = self._free_bank(pd)
        if bank is not None:
            self._attach(dom, bank)
            return Binding(bank=bank)

        victim = self._steal_victim(fault_active)
        if victim is None:
            raise NoBankAvailable(
                f"pd {pd}: no bound context bank to steal")
        bank = victim.bank
        assert bank is not None
        if victim.steal_immune:
            self.stats.immune_steals += 1
        victim.bank = None
        del self._bank_owner[bank]
        self.stats.steals += 1
        self._attach(dom, bank)
        return Binding(bank=bank, stolen=True, victim_pd=victim.pd)

    def _attach(self, dom: _Domain, bank: int) -> None:
        dom.bank = bank
        self._bank_owner[bank] = dom.pd
        self.stats.binds += 1
        if dom.ever_bound:
            self.stats.rebinds += 1
        dom.ever_bound = True

    def _free_bank(self, pd: int) -> Optional[int]:
        if self.capacity == 0:
            return None
        preferred = pd % self.capacity
        if preferred not in self._bank_owner:
            return preferred
        for bank in range(self.capacity):
            if bank not in self._bank_owner:
                return bank
        return None

    def try_bind(self, pd: int) -> Optional[int]:
        """Bind only if a bank is free (eager bind at create_domain);
        returns the bank or ``None`` without ever stealing."""
        dom = self._domains[pd]
        if dom.bank is not None:
            return dom.bank
        bank = self._free_bank(pd)
        if bank is not None:
            self.touch(pd)
            self._attach(dom, bank)
        return bank

    def _steal_victim(self, fault_active) -> Optional[_Domain]:
        """LRU victim, preferring (in order): non-immune quiet banks,
        immune quiet banks, then fault-active banks as a last resort —
        losing a fault record only costs the faulting block its 1 ms
        timeout round, while refusing to bind would deadlock the node."""
        def lru(candidates):
            return min(candidates,
                       key=lambda d: (d.last_use, d.bank),
                       default=None)
        # torch-lint: allow(det-dict-iter): feeds min() with a unique tie-break key
        bound = [self._domains[pd] for pd in self._bank_owner.values()]
        quiet = [d for d in bound if not fault_active(d.bank)]
        return (lru([d for d in quiet if not d.steal_immune])
                or lru(quiet)
                or lru([d for d in bound if not d.steal_immune])
                or lru(bound))
