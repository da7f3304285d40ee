"""Quickstart: the paper's mechanism through the verbs API, in seven steps,
on the PyTorch port (``repro_torch``; prints what ``quickstart.py`` prints).

    PYTHONPATH=src python examples/torch_quickstart.py

1. Build a two-node virtual-address RDMA fabric (``Fabric.build``).
2. Open a protection domain (PDID) with a fault policy; register memory
   WITHOUT pinning (demand paging on).
3. Post an asynchronous remote write whose destination pages are not
   resident — ``post_write`` returns a WorkRequest future immediately.
4. Watch the mechanism: NACK -> fault FIFO -> driver tasklet ->
   Touch-Ahead page-in -> RAPF -> retransmission -> completion on the CQ.
5. Compare against the pinning baseline.
6. Multi-tenancy: a second domain on the SAME fabric resolving its faults
   with a different policy (Kernel-RAPF — no user-space hop).
7. Same idea on the ML data plane: a paged KV pool with a spilled page.
"""

from repro_torch.api import (BufferPrep, Fabric, FabricConfig, FaultPolicy,
                       Strategy)
from repro_torch.memory.kv_cache import PagedKVManager

SRC, DST, SIZE = 0x10_0000_0000, 0x20_0000_0000, 65536


def main() -> None:
    print("== 1-4: async remote write with destination faults "
          "(Touch-Ahead) ==")
    fabric = Fabric.build(FabricConfig(n_nodes=2))
    tenant = fabric.open_domain(1, policy=FaultPolicy(Strategy.TOUCH_AHEAD))
    src = tenant.register_memory(0, SRC, SIZE, prep=BufferPrep.TOUCHED)
    dst = tenant.register_memory(1, DST, SIZE)                   # not pinned!
    cq = fabric.create_cq(depth=16)
    wr = tenant.post_write(src, dst, cq=cq)       # returns before completion
    print(f"  posted wr_id={wr.wr_id}; done yet? {wr.done}")
    (wc,) = cq.wait(1)
    st = wc.stats
    print(f"  64KB write completed in {wc.latency_us:.1f} us")
    print(f"  faults at dst: {st.dst_faults}, FIFO entries handled: "
          f"{st.fifo_entries_handled} "
          f"(skipped dups: {st.fifo_entries_skipped})")
    print(f"  explicit RAPF retransmissions: {st.rapf_retransmits}, "
          f"timeouts: {st.timeouts}")
    print(f"  driver time {st.driver_us:.1f} us, library-thread time "
          f"{st.user_us:.1f} us")

    print("\n== 5: the pinning alternative ==")
    fabric2 = Fabric.build(FabricConfig(n_nodes=2))
    dom2 = fabric2.open_domain(1)
    p_src = dom2.register_memory(0, SRC, SIZE, prep=BufferPrep.PINNED)
    p_dst = dom2.register_memory(1, DST, SIZE, prep=BufferPrep.PINNED)
    cq2 = fabric2.create_cq()
    dom2.post_write(p_src, p_dst, cq=cq2)
    (wc2,) = cq2.wait(1)
    print(f"  pinned transfer: {wc2.latency_us:.1f} us + pin/unpin overhead "
          f"{p_src.prep_cost.total_us + p_dst.prep_cost.total_us:.1f} us "
          f"on the critical path")
    print("  (and the memory stays locked — the thesis' utilization argument)")

    print("\n== 6: second tenant, same fabric, different fault policy ==")
    tenant_b = fabric.open_domain(2, policy=FaultPolicy(Strategy.KERNEL_RAPF))
    src_b = tenant_b.register_memory(0, SRC, SIZE, prep=BufferPrep.TOUCHED)
    dst_b = tenant_b.register_memory(1, 0x30_0000_0000, SIZE)
    wr_b = tenant_b.post_write(src_b, dst_b, cq=cq)
    wc_b = wr_b.result()
    print(f"  tenant A (TOUCH_AHEAD):  user-thread time {st.user_us:.1f} us")
    print(f"  tenant B (KERNEL_RAPF):  user-thread time "
          f"{wc_b.stats.user_us:.1f} us (RAPF sent from kernel space)")

    print("\n== 7: the same mechanism on a paged KV cache ==")
    kv = PagedKVManager(n_frames=8, page_tokens=256, max_pages_per_seq=8,
                        policy=FaultPolicy(Strategy.TOUCH_AHEAD))
    kv.add_sequence(1)
    kv.append_tokens(1, 2048)          # fills the pool
    kv.add_sequence(2)
    kv.append_tokens(2, 512, spill_candidates=[1])   # seq 1 pages spill
    print(f"  pool spills while admitting seq 2: {kv.stats.spills}")
    n = kv.ensure_resident(1, spill_candidates=[2])  # seq 1 scheduled again
    print(f"  re-activating seq 1 faulted {n} pages back in "
          f"({kv.stats.fault_events} fault events — Touch-Ahead blocks)")
    print(f"  simulated fault-handling time: {kv.stats.simulated_us:.1f} us")


if __name__ == "__main__":
    main()
