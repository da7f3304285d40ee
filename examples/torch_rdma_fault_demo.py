"""Deep-dive demo: every fault scenario of Chapter 4, side by side, on the
PyTorch port (``repro_torch``; prints what ``rdma_fault_demo.py`` prints).

    PYTHONPATH=src python examples/torch_rdma_fault_demo.py
"""

from repro_torch.api import BufferPrep
from repro_torch.core.experiments import run_remote_write
from repro_torch.core.resolver import Strategy

CASES = [
    ("no faults (pre-touched)", BufferPrep.TOUCHED, BufferPrep.TOUCHED),
    ("fault at destination", BufferPrep.TOUCHED, BufferPrep.FAULTING),
    ("fault at source", BufferPrep.FAULTING, BufferPrep.TOUCHED),
    ("faults at both", BufferPrep.FAULTING, BufferPrep.FAULTING),
]


def main() -> None:
    print(f"{'scenario':28s} {'strategy':14s} {'16KB':>10s} {'64KB':>10s} "
          f"{'timeouts':>9s} {'RAPFs':>6s}")
    for name, sp, dp in CASES:
        for strat in (Strategy.TOUCH_A_PAGE, Strategy.TOUCH_AHEAD):
            r16 = run_remote_write(16384, sp, dp, strategy=strat)
            r64 = run_remote_write(65536, sp, dp, strategy=strat)
            print(f"{name:28s} {strat.value:14s} {r16.latency_us:9.1f}us "
                  f"{r64.latency_us:9.1f}us {r64.stats.timeouts:9d} "
                  f"{r64.stats.rapf_retransmits:6d}")

    print("\nKey effects (cf. thesis Figs 4.2-4.6):")
    print(" * dst faults recover via explicit RAPF — microseconds;")
    print(" * src faults wait for the 1ms timeout — Touch-A-Page pays it per")
    print("   page, Touch-Ahead per 16KB block (the ~3.9x);")
    print(" * faults on both sides let dst NACKs stand in for src timeouts.")


if __name__ == "__main__":
    main()
