"""Multi-node paged serving, step one: KV frames paged in OVER THE FABRIC,
on the PyTorch port (``repro_torch``; prints what ``remote_paged_kv.py``
prints).

A ``PagedKVManager`` whose frame pool is a ``RemoteFramePool``: when a
preempted sequence is re-activated, its spilled KV pages fault back in
as verbs ``post_read``s against the remote node's memory — destination
faults at the FAULTING landing buffer are resolved by the thesis
mechanism (fault FIFO → tasklet → resolver → RAPF retransmit) and every
page-in completes on a real CompletionQueue.

    PYTHONPATH=src python examples/torch_remote_paged_kv.py
"""

from repro_torch.api import FaultPolicy, Strategy
from repro_torch.memory.kv_cache import PagedKVManager
from repro_torch.vmem import FrameIdPool, RemoteFramePool


def main() -> None:
    for strategy in (Strategy.TOUCH_A_PAGE, Strategy.TOUCH_AHEAD):
        pool = RemoteFramePool.build(n_frames=8, page_elems=0, n_pages=16,
                                     local=FrameIdPool(8))
        kv = PagedKVManager(n_frames=8, page_tokens=4, max_pages_per_seq=8,
                            policy=FaultPolicy(strategy, lookahead=4),
                            pool=pool)
        kv.add_sequence(1)
        kv.append_tokens(1, 32)                        # seq 1 fills the pool
        kv.add_sequence(2)
        kv.append_tokens(2, 16, spill_candidates=[1])  # admission spills seq 1
        n = kv.ensure_resident(1, spill_candidates=[2])
        s = kv.stats
        wcs = pool.cq.poll(max_entries=64) + pool.completions
        print(f"{strategy.value:14s}: {n} KV pages faulted back in over the "
              f"fabric in {s.remote_reads} verbs read(s)")
        print(f"  {'':14s}  completions on CQ: "
              f"{[f'{wc.nbytes}B @ {wc.latency_us:.1f}us' for wc in wcs]}")
        print(f"  {'':14s}  dst_faults={s.remote_dst_faults} "
              f"rapf_retransmits={s.rapf_retransmits} "
              f"simulated fault time={s.simulated_us:.1f}us")

    print("\nTouch-Ahead fetches a spilled sequence's block in ONE remote "
          "read")
    print("(one fault + one RAPF on the cold landing page); Touch-A-Page pays")
    print("a read per page — the thesis' contrast, now on the KV spill path.")


if __name__ == "__main__":
    main()
