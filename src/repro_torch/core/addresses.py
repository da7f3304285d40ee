"""Address-space constants and helpers for the virtual-address RDMA system.

Mirrors the ExaNeSt / FORTH PLDMA environment described in the paper:

* 4 KB OS pages (the SMMU translation granule used by the thesis),
* transfers segmented by the R5 scheduler into 16 KB *blocks* (4 pages),
* blocks segmented by hardware into 256 B *packets* (the PLDMA MTU),
* 39-bit virtual addresses, 16-bit protection-domain IDs (16 SMMU context
  banks in the Zynq UltraScale+), 14-bit transaction IDs, 22-bit source-node
  IDs, 14-bit sequence numbers (Table 3.1 / Table 3.2).
"""

from __future__ import annotations

import dataclasses

# ---------------------------------------------------------------------------
# Paper constants (Section 1.3.2, 3.2.3.1, Appendix A)
# ---------------------------------------------------------------------------

PAGE_SIZE = 4096                       # bytes; SMMU/OS translation granule
BLOCK_SIZE = 16 * 1024                 # bytes; R5 segmentation unit
MTU = 256                              # bytes; PLDMA packet size
PAGES_PER_BLOCK = BLOCK_SIZE // PAGE_SIZE          # 4
PACKETS_PER_BLOCK = BLOCK_SIZE // MTU              # 64
PACKETS_PER_PAGE = PAGE_SIZE // MTU                # 16

VA_BITS = 39                           # system virtual-address width
NUM_CONTEXT_BANKS = 16                 # SMMU context banks == protection domains
VIRTUAL_CHANNELS_PER_PD = 64           # R5 virtual channels per protection domain
MAX_OUTSTANDING_TRANSFERS = VIRTUAL_CHANNELS_PER_PD * NUM_CONTEXT_BANKS  # 1024
OUTSTANDING_BLOCKS_PER_TRANSFER = 2    # "parameterized ... currently two (2)"

SRC_ID_BITS = 22
TR_ID_BITS = 14
SEQ_NUM_BITS = 14
PDID_BITS = 16
IOVA_FIELD_BITS = 32                   # FIFO/netlink field: 4b process idx + 28b VPN

SRC_ID_MASK = (1 << SRC_ID_BITS) - 1
TR_ID_MASK = (1 << TR_ID_BITS) - 1
SEQ_NUM_MASK = (1 << SEQ_NUM_BITS) - 1
PDID_MASK = (1 << PDID_BITS) - 1

#: size of the per-node transaction-ID space: the wire carries 14-bit
#: tr_IDs (Table 3.2), so a node can have at most this many blocks in
#: flight — ID reuse beyond it is a *protocol property*, handled by the
#: R5's free-list allocator (recycle on completion, host-side generation
#: tags), not an overflow bug.
TR_ID_SPACE = 1 << TR_ID_BITS

# RAPF mailbox opcode ("Retransmit After Page Fault handled", Section 3.2.1)
OPCODE_RAPF = 2

# Default R5 retransmission timeout.  The thesis tried 25 ms, 2.5 ms and 1 ms
# and found 1 ms best (Chapter 4); times here are microseconds.
DEFAULT_TIMEOUT_US = 1000.0
TIMEOUT_SWEEP_US = (25_000.0, 2_500.0, 1_000.0)


def page_index(va: int) -> int:
    """Virtual page number of a virtual address."""
    return va >> 12


def page_offset(va: int) -> int:
    return va & (PAGE_SIZE - 1)


def page_base(va: int) -> int:
    return va & ~(PAGE_SIZE - 1)


def block_base(va: int) -> int:
    return va & ~(BLOCK_SIZE - 1)


def num_pages(va: int, nbytes: int) -> int:
    """Number of 4 KB pages touched by [va, va+nbytes)."""
    if nbytes <= 0:
        return 0
    first = page_index(va)
    last = page_index(va + nbytes - 1)
    return last - first + 1


def pages_spanned(va: int, nbytes: int) -> list[int]:
    if nbytes <= 0:
        return []
    first = page_index(va)
    last = page_index(va + nbytes - 1)
    return list(range(first, last + 1))


def split_blocks(va: int, nbytes: int) -> list[tuple[int, int]]:
    """Segment a transfer into 16 KB-aligned blocks (R5 behaviour).

    Returns ``[(block_va, block_bytes), ...]``.  Blocks are 16 KB aligned, so
    the first/last block may be shorter than 16 KB (Section 1.3.2).
    """
    out: list[tuple[int, int]] = []
    cur = va
    end = va + nbytes
    while cur < end:
        boundary = block_base(cur) + BLOCK_SIZE
        chunk_end = min(boundary, end)
        out.append((cur, chunk_end - cur))
        cur = chunk_end
    return out


def num_packets(nbytes: int) -> int:
    return max(1, -(-nbytes // MTU))


@dataclasses.dataclass(frozen=True)
class NetlinkMessage:
    """Kernel → user message, Table 3.1 (99 bits, sent as hex string).

    ``Src_ID (22) | Tr_ID (14) | Seq_Num (14) | Faulty IOVA (32) | PDID (16)
    | R/W (1, LSB)``.  R/W == 0 → fault at *source* buffer (read access),
    R/W == 1 → fault at *destination* buffer (write access).
    """

    src_id: int
    tr_id: int
    seq_num: int
    iova_field: int     # 4-bit process index + 28-bit VPN field
    pdid: int
    rw: int             # 0 = read/source fault, 1 = write/destination fault

    def encode(self) -> int:
        v = self.src_id & SRC_ID_MASK
        v = (v << TR_ID_BITS) | (self.tr_id & TR_ID_MASK)
        v = (v << SEQ_NUM_BITS) | (self.seq_num & SEQ_NUM_MASK)
        v = (v << IOVA_FIELD_BITS) | (self.iova_field & 0xFFFF_FFFF)
        v = (v << PDID_BITS) | (self.pdid & PDID_MASK)
        v = (v << 1) | (self.rw & 1)
        return v

    def encode_hex(self) -> str:
        # 22+14+14+32+16+1 = 99 bits -> 25 hex digits
        return f"{self.encode():025x}"

    @staticmethod
    def decode(v: int) -> "NetlinkMessage":
        rw = v & 1
        v >>= 1
        pdid = v & PDID_MASK
        v >>= PDID_BITS
        iova_field = v & 0xFFFF_FFFF
        v >>= IOVA_FIELD_BITS
        seq_num = v & SEQ_NUM_MASK
        v >>= SEQ_NUM_BITS
        tr_id = v & TR_ID_MASK
        v >>= TR_ID_BITS
        src_id = v & SRC_ID_MASK
        return NetlinkMessage(src_id, tr_id, seq_num, iova_field, pdid, rw)

    @staticmethod
    def decode_hex(s: str) -> "NetlinkMessage":
        return NetlinkMessage.decode(int(s, 16))


def iova_field_pack(process_index: int, vpn: int) -> int:
    """Pack the 32-bit FIFO/netlink IOVA field (Section 3.2.3.2).

    4 MSBs = process index within the protection domain; 28 LSBs = the most
    significant bits of a 39-bit VA, i.e. the 27-bit VPN with bit 27 wired 0.
    """
    return ((process_index & 0xF) << 28) | (vpn & 0x0FFF_FFFF)


def iova_field_unpack(field: int) -> tuple[int, int]:
    return (field >> 28) & 0xF, field & 0x0FFF_FFFF


@dataclasses.dataclass(frozen=True)
class RAPFMessage:
    """Mailbox message requesting retransmission (opcode 2, Section 3.2.3.3).

    The low 12 bits after the opcode are *wired* by the kernel-space
    packetizer (the wired PDID) and cannot be forged from user space; R5
    cross-checks the wired PDID against the user-supplied one.
    """

    wired_pdid: int     # wired by the packetizer (trusted)
    rcved_pdid: int     # supplied by user space (untrusted)
    tr_id: int
    seq_num: int
    opcode: int = OPCODE_RAPF

    def encode_words(self) -> tuple[int, int]:
        word0 = (self.opcode & 0x3) | ((self.wired_pdid & PDID_MASK) << 2) | (
            (self.tr_id & TR_ID_MASK) << (2 + 16))
        word1 = (self.seq_num & 0xFFF) | ((self.rcved_pdid & PDID_MASK) << 12)
        return word0, word1

    @staticmethod
    def decode_words(word0: int, word1: int) -> "RAPFMessage":
        opcode = word0 & 0x3
        wired_pdid = (word0 >> 2) & PDID_MASK
        tr_id = (word0 >> (2 + 16)) & TR_ID_MASK
        seq_num = word1 & 0xFFF
        rcved_pdid = (word1 >> 12) & PDID_MASK
        return RAPFMessage(wired_pdid=wired_pdid, rcved_pdid=rcved_pdid,
                           tr_id=tr_id, seq_num=seq_num, opcode=opcode)
