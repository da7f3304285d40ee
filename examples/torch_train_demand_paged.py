"""End-to-end training driver on the PyTorch port (the twin of
``train_demand_paged.py``): trains a qwen3-family model (52.4M parameters
at the defaults) for a few hundred steps with:

  * per-layer remat,
  * checkpoint/restart (kill it mid-run and start again: it resumes),
  * host-paged optimizer state streamed block-wise with Touch-Ahead
    prefetch — the thesis' mechanism applied to training memory.

    PYTHONPATH=src python examples/torch_train_demand_paged.py [--steps 300]
        [--device cpu]

Runs on the GPU by default (and raises without one), in float32 as the
reference does: attention and its gradient run the hand-written flash
kernels on their f32 route, the optimizer's page-ins and accesses the
page-copy kernels.  ``--device cpu`` runs the plain versions.  The size
and logging flags default to the reference's values.
"""

import argparse
import time

import torch

from repro_torch.configs import get_config
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.distributed.checkpoint import Checkpointer
from repro_torch.memory.offload import PagedAdamW
from repro_torch.models.config import reduced
from repro_torch.models.registry import model_for
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.optim.schedules import cosine_with_warmup
from repro_torch.training.trainer import (TrainConfig, make_loss_fn,
                                          value_and_grad)
from repro_torch.tree import tree_leaves


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--checkpoint-dir", default="/tmp/repro_torch_train_demo")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' to run on "
                         "the CPU)")
    ap.add_argument("--layers", type=int, default=6)
    ap.add_argument("--d-model", type=int, default=512)
    ap.add_argument("--heads", type=int, default=8)
    ap.add_argument("--kv-heads", type=int, default=4)
    ap.add_argument("--head-dim", type=int, default=64)
    ap.add_argument("--d-ff", type=int, default=1536)
    ap.add_argument("--vocab", type=int, default=32768)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--log-every", type=int, default=25)
    ap.add_argument("--checkpoint-every", type=int, default=100)
    args = ap.parse_args()

    # 52.4M params: qwen3 family, reduced depth/width
    cfg = reduced(get_config("qwen3_14b"), n_layers=args.layers,
                  d_model=args.d_model, head_dim=args.head_dim,
                  n_heads=args.heads, n_kv_heads=args.kv_heads,
                  d_ff=args.d_ff, vocab_size=args.vocab, dtype="float32")
    model = model_for(cfg)
    params = model.init_params(cfg, 0, device=args.device)
    device = tree_leaves(params)[0].device
    n = sum(x.numel() for x in tree_leaves(params))
    print(f"model: {cfg.name}-reduced, {n/1e6:.1f}M params")

    opt_cfg = AdamWConfig(lr=3e-4, schedule=cosine_with_warmup(3e-4, 30,
                                                               args.steps))
    paged_opt = PagedAdamW(opt_cfg, params, block_elems=1 << 21,
                           device=args.device)
    print(f"optimizer moments: host-paged, device working set "
          f"{paged_opt.device_bytes_resident()/2**20:.0f} MiB "
          f"(vs {2*n*4/2**20:.0f} MiB fully resident)")

    tcfg = TrainConfig(microbatches=2, remat=True,
                       optimizer=opt_cfg)
    loss_fn = make_loss_fn(cfg, tcfg)
    ds = SyntheticLM(cfg.vocab_size, seq_len=args.seq,
                     batch_per_shard=args.batch)
    ck = Checkpointer()

    step0 = 0
    restored = ck.restore_latest(args.checkpoint_dir, params)
    if restored is not None:
        params, _, step0 = restored
        print(f"resumed from checkpoint at step {step0}")

    t0 = time.perf_counter()
    for step in range(step0, args.steps):
        tokens, labels = (torch.from_numpy(a).to(device)
                          for a in ds.batch_at(step))
        loss, grads = value_and_grad(loss_fn, params, tokens, labels)
        params = paged_opt.update(params, grads)
        if (step + 1) % args.log_every == 0:
            dt = (time.perf_counter() - t0) / args.log_every
            print(f"step {step+1:4d}  loss {float(loss):.4f}  {dt:.2f}s/step  "
                  f"opt-blocks streamed {paged_opt.stats.blocks_streamed} "
                  f"(prefetch overlap {paged_opt.stats.prefetch_overlapped})")
            t0 = time.perf_counter()
        if (step + 1) % args.checkpoint_every == 0:
            ck.save(args.checkpoint_dir, params, None, step + 1)
            print(f"  checkpoint @ {step+1}")
    print("done.")


if __name__ == "__main__":
    main()
