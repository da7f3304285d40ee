"""The receive-path fault FIFO added to the FORTH PLDMA (thesis §3.2.3.1).

512-deep, 128-bit-wide hardware FIFO logging every NACKed (AXI slave-error)
packet: ``(src_ID, tr_ID, seq_num, PDID, faulty IOVA, EXA_ACK, R/W)``.

Faithful details implemented here:

* **Layout** — the four 32-bit words of Table 3.2, bit-exact packing and
  unpacking (valid bits in each word, wired-zero fields).
* **Read FSM** — entries are consumed by *two 64-bit reads*; only the read
  of the *second* half pops the entry; re-reading the second half first does
  not pop (§3.2.3.1 "the FSM ensures that this happens in a safe order").
* **Hardware dedup** — a new slave error is *not* pushed if it matches the
  most recently pushed entry on (src_ID, tr_ID, seq_num, virtual page)
  (§3.2.3.1 "if it has the same ... with the entry we added last time, we do
  not add it again").  Interleaved blocks (window = 2) still produce
  duplicates — the effect the thesis measures at 32/64 KB — which the
  *driver-side* last-2 check absorbs (see resolver.py).
* Overflow drops (FIFO full) are counted: lost entries are recovered by the
  R5 timeout path, another reason timeouts back-stop the mechanism.

**Generation sidecar (host-side, beyond the 128-bit wire format).**  Once a
node has launched 2^14 blocks, tr_IDs recycle and the wire key
``(src_ID, tr_ID, seq_num, vpage)`` aliases across *incarnations* of the
same ID.  The simulator keeps a per-entry generation tag *alongside* the
FIFO — ``push(entry, gen=...)`` / ``last_popped_gen`` — so the dedup
comparison and the driver's RAPF attribution stay correct under wrap.  The
tag never enters :meth:`FIFOEntry.pack_words`: the four 32-bit words of
Table 3.2 remain bit-exact, and the real hardware (which cannot see
generations) would fall back to the R5 timeout in the rare cross-incarnation
collision this tag disambiguates.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Optional

FIFO_DEPTH = 512


@dataclasses.dataclass(frozen=True)
class FIFOEntry:
    src_id: int        # 22 bits: initiator node
    tr_id: int         # 14 bits
    seq_num: int       # 14 bits
    pdid: int          # 16 bits
    iova_field: int    # 32 bits: 4b process index + 28b VPN field
    exa_ack: int = 0   # 2 bits
    rw: int = 1        # write (destination) faults land here

    # ---- Table 3.2 bit-exact packing -----------------------------------
    def pack_words(self) -> tuple[int, int, int, int]:
        w0 = (((self.src_id & 0x3FFFFF) << 8)
              | (((self.tr_id >> 12) & 0x3) << 4)
              | 0x1)                                     # valid bit
        w1 = (((self.tr_id & 0xFFF) << 20)
              | ((self.seq_num & 0x3FFF) << 4)
              | 0x1)
        w2 = (((self.pdid & 0xFFFF) << 16)
              | (((self.iova_field >> 20) & 0xFFF) << 4)
              | ((self.exa_ack & 0x3) << 1)
              | 0x1)
        w3 = (((self.iova_field & 0xFFFFF) << 12)
              | 0x1)
        return w0, w1, w2, w3

    @staticmethod
    def unpack_words(w0: int, w1: int, w2: int, w3: int) -> "FIFOEntry":
        src_id = (w0 >> 8) & 0x3FFFFF
        tr_hi = (w0 >> 4) & 0x3
        tr_lo = (w1 >> 20) & 0xFFF
        seq = (w1 >> 4) & 0x3FFF
        pdid = (w2 >> 16) & 0xFFFF
        iova_hi = (w2 >> 4) & 0xFFF
        exa_ack = (w2 >> 1) & 0x3
        iova_lo = (w3 >> 12) & 0xFFFFF
        return FIFOEntry(src_id=src_id, tr_id=(tr_hi << 12) | tr_lo,
                         seq_num=seq, pdid=pdid,
                         iova_field=(iova_hi << 20) | iova_lo,
                         exa_ack=exa_ack)

    def vpage_key(self) -> tuple[int, int, int, int]:
        """Dedup key: src, transaction, sequence, virtual page (no offset)."""
        return (self.src_id, self.tr_id, self.seq_num,
                self.iova_field)  # iova_field already excludes the offset


@dataclasses.dataclass
class FIFOStats:
    pushes: int = 0
    dedup_skips: int = 0
    overflow_drops: int = 0
    pops: int = 0
    max_occupancy: int = 0


class FaultFIFO:
    def __init__(self, depth: int = FIFO_DEPTH):
        self.depth = depth
        self._q: deque[FIFOEntry] = deque()
        #: host-side generation sidecar, parallel to ``_q`` (see module
        #: docstring) — not part of the 128-bit hardware entry
        self._gen_q: deque[int] = deque()
        self._last_pushed: Optional[FIFOEntry] = None
        self._last_gen = 0
        self._read_lo_done = False
        #: packed words of the head entry, cached between the FSM's two
        #: 64-bit reads (the head only changes on pop) — at scale the
        #: double bit-exact repack per pop was a measurable hot spot
        self._head_words: Optional[tuple[int, int, int, int]] = None
        #: generation tag of the entry most recently popped by the
        #: two-read FSM (0 when the pusher supplied none)
        self.last_popped_gen = 0
        self.stats = FIFOStats()

    def __len__(self) -> int:
        return len(self._q)

    @property
    def empty(self) -> bool:
        return not self._q

    # ---------------------------------------------------------------- push
    def push(self, entry: FIFOEntry, gen: int = 0) -> bool:
        """Hardware push on slave error.  Returns True if enqueued.

        ``gen`` is the host-side incarnation tag of ``entry.tr_id`` (0 =
        untagged): the consecutive-dedup only collapses entries of the
        *same* incarnation, so a recycled tr_ID faulting on the same page
        as its previous life still logs its entry.
        """
        if (self._last_pushed is not None
                and self._last_gen == gen
                and self._last_pushed.vpage_key() == entry.vpage_key()):
            self.stats.dedup_skips += 1
            return False
        if len(self._q) >= self.depth:
            self.stats.overflow_drops += 1
            return False
        self._q.append(entry)
        self._gen_q.append(gen)
        self._last_pushed = entry
        self._last_gen = gen
        self.stats.pushes += 1
        self.stats.max_occupancy = max(self.stats.max_occupancy, len(self._q))
        return True

    def break_dedup(self) -> None:
        """Forget the last-pushed entry, as an interleaved packet stream does.

        The hardware dedup only compares against the *immediately preceding*
        slave error; when two blocks' NACK packets interleave on the wire,
        the comparison never matches (§ Fig 4.2).  The PLDMA model calls
        this between pushes to reproduce that effect.
        """
        self._last_pushed = None

    # ---------------------------------------------------- two-read-pop FSM
    def read64(self, half: int) -> int:
        """AXI-lite 64-bit read.  ``half``: 0 = low, 1 = high (pops).

        Reading the high half without having read the low half first returns
        the data but does **not** pop (safe-order FSM, §3.2.3.1).
        """
        if not self._q:
            return 0
        words = self._head_words
        if words is None:
            words = self._head_words = self._q[0].pack_words()
        w0, w1, w2, w3 = words
        if half == 0:
            self._read_lo_done = True
            return (w1 << 32) | w0
        value = (w3 << 32) | w2
        if self._read_lo_done:
            self._q.popleft()
            self.last_popped_gen = self._gen_q.popleft()
            self._read_lo_done = False
            self._head_words = None
            self.stats.pops += 1
        return value

    def pop_entry(self) -> Optional[FIFOEntry]:
        """Driver convenience: the two 64-bit reads, decoded.

        Returns the head entry object directly instead of packing and
        re-decoding the four words — the roundtrip is bit-exact for every
        in-range field (``read64`` keeps the word-level FSM for register
        clients), and the pop bookkeeping below is identical to a
        low-then-high read pair.
        """
        if not self._q:
            return None
        head = self._q.popleft()
        self.last_popped_gen = self._gen_q.popleft()
        self._read_lo_done = False
        self._head_words = None
        self.stats.pops += 1
        return head
