"""End-to-end serving driver on the PyTorch port: batched requests against a
paged KV cache with an UNDERSIZED frame pool, so admission forces spills and
re-activation faults pages back in Touch-Ahead style.  The twin of
``serve_paged_kv.py``: the same scenario, the same two stats lines.

    PYTHONPATH=src python examples/torch_serve_paged_kv.py [--device cpu]

Runs on the GPU by default (and raises without one); ``--device cpu`` runs
on the CPU.  At its defaults (the reference's scenario) the reduced
H2O-Danube keeps its 32-token window, so decode attends over a ring buffer
in plain PyTorch and no kernel of the port runs; ``--window 0`` turns the
window off, so decode takes the paged KV pools: the hand-written
paged-attention kernel, and the page-copy kernels for every batch step's
copies in and out, with the same stats.
"""

import argparse
import dataclasses

import numpy as np

from repro_torch.api import FaultPolicy, Strategy
from repro_torch.configs import get_config
from repro_torch.models.config import reduced
from repro_torch.models.registry import model_for
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.sampler import SamplerConfig


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' to run on "
                         "the CPU)")
    ap.add_argument("--window", type=int, default=None,
                    help="attention window (default: the reduced config's, "
                         "32; 0 decodes through the paged KV pools)")
    args = ap.parse_args()

    cfg = reduced(get_config("h2o_danube_1_8b"), n_layers=3)
    if args.window is not None:
        cfg = dataclasses.replace(cfg, sliding_window=args.window)
    model = model_for(cfg)
    params = model.init_params(cfg, 0, device=args.device)

    for strategy in (Strategy.TOUCH_A_PAGE, Strategy.TOUCH_AHEAD):
        eng = ServingEngine(cfg, params, max_batch=2, max_len=96,
                            pool_frames=5,           # undersized on purpose
                            policy=FaultPolicy(strategy=strategy),
                            sampler=SamplerConfig(temperature=0.0),
                            device=args.device)
        rng = np.random.default_rng(0)
        reqs = [eng.submit(rng.integers(0, cfg.vocab_size, size=20),
                           max_new_tokens=14) for _ in range(5)]
        eng.run_until_done()
        s = eng.stats
        kv = eng.kv.stats
        print(f"{strategy.value:14s}: {s.tokens_generated} tokens, "
              f"{s.decode_steps} decode steps, spills={kv.spills}, "
              f"fault_events={kv.fault_events}, "
              f"page-ins={kv.fault_page_ins}, "
              f"simulated fault time={kv.simulated_us:.1f}us")
    print("\nTouch-Ahead resolves a spilled sequence in block-granular fault")
    print("events; Touch-A-Page pays one event per page "
          "(the thesis' contrast).")


if __name__ == "__main__":
    main()
