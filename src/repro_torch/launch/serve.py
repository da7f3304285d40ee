"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id> [...]``.

Runs the continuous-batching engine with a paged, host-spillable KV pool —
exercising the thesis mechanism end to end: admission, prefill, pool
exhaustion → spill, re-activation → Touch-Ahead page-in, decode through
the page table.  By default the config is reduced to a tiny same-family
model; ``--full-width`` keeps the published widths and depth.  Runs on the
GPU unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np

from repro_torch.api import FaultPolicy, Strategy
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.models.config import reduced
from repro_torch.models.registry import model_for
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.sampler import SamplerConfig


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3_14b", choices=ARCH_IDS)
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--max-batch", type=int, default=2)
    ap.add_argument("--max-len", type=int, default=96)
    ap.add_argument("--pool-frames", type=int, default=0,
                    help="undersize to force spills (0 = exact fit)")
    ap.add_argument("--strategy", default="touch_ahead",
                    choices=[s.value for s in Strategy])
    ap.add_argument("--lookahead", type=int, default=4,
                    help="pages per fault event (TOUCH_AHEAD_N / STREAM)")
    ap.add_argument("--pin-all", action="store_true",
                    help="pinning baseline: admission-controlled residency")
    ap.add_argument("--temperature", type=float, default=0.8)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' to run on "
                         "the CPU)")
    ap.add_argument("--full-width", action="store_true",
                    help="serve the published config, not the reduced one")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if not args.full_width:
        cfg = reduced(cfg)
    model = model_for(cfg)
    params = model.init_params(cfg, 0, device=args.device)
    policy = FaultPolicy(strategy=Strategy(args.strategy),
                         lookahead=args.lookahead)
    eng = ServingEngine(
        cfg, params, max_batch=args.max_batch, max_len=args.max_len,
        pool_frames=args.pool_frames or None,
        policy=policy, pin_all=args.pin_all,
        sampler=SamplerConfig(temperature=args.temperature),
        device=args.device)

    rng = np.random.default_rng(0)
    reqs = [eng.submit(rng.integers(0, cfg.vocab_size, size=rng.integers(3, 9)),
                       max_new_tokens=args.max_new)
            for _ in range(args.requests)]
    eng.run_until_done()
    for r in reqs:
        print(f"req {r.req_id}: prompt[{len(r.prompt)}] -> {r.generated}")
    s = eng.stats
    print(f"\nstats: prefills={s.prefills} decode_steps={s.decode_steps} "
          f"tokens={s.tokens_generated} spills={s.spill_events} "
          f"fault_page_ins={s.fault_page_ins} "
          f"sim_fault_us={s.simulated_fault_us:.1f}")


if __name__ == "__main__":
    main()
