"""Training launcher: ``python -m repro_torch.launch.train --arch <id> [...]``.

Trains a reduced config by default (``--full`` for the published one) on
synthetic data with AdamW, cosine schedule and optional checkpoints.  Runs
on the GPU unless ``--device cpu`` is given; on the GPU attention and its
gradient run on the hand-written flash-attention kernels.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.data.pipeline import ShardInfo, SyntheticLM
from repro_torch.distributed.checkpoint import Checkpointer
from repro_torch.models.config import reduced
from repro_torch.models.registry import model_for
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.optim.schedules import cosine_with_warmup
from repro_torch.training.trainer import TrainConfig, Trainer
from repro_torch.tree import tree_leaves


def main(argv: Optional[Sequence[str]] = None) -> list[dict]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3_14b", choices=ARCH_IDS)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--reduced", action="store_true", default=True,
                    help="train the reduced config (CPU default)")
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' to run on "
                         "the CPU)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg, n_layers=4, d_model=128, d_ff=256 if cfg.d_ff else 0,
                      vocab_size=512)
    model = model_for(cfg)
    params = model.init_params(cfg, args.seed, device=args.device)
    n_params = sum(x.numel() for x in tree_leaves(params))
    print(f"arch={cfg.name} family={cfg.family} params={n_params:,}")

    tcfg = TrainConfig(
        microbatches=args.microbatches,
        optimizer=AdamWConfig(
            lr=args.lr,
            schedule=cosine_with_warmup(args.lr, 20, args.steps)))
    ds = SyntheticLM(cfg.vocab_size, args.seq, args.batch,
                     ShardInfo(0, 1), seed=args.seed)
    ckpt = Checkpointer() if args.checkpoint_dir else None
    tr = Trainer(cfg, tcfg, params, ds, checkpoint_dir=args.checkpoint_dir,
                 checkpoint_every=args.checkpoint_every, checkpointer=ckpt,
                 device=args.device)
    if args.resume and tr.restore():
        print(f"resumed from step {tr.step}")
    hist = tr.run(args.steps, log_every=10)
    print(f"final loss: {hist[-1]['loss']:.4f} "
          f"(start {hist[0]['loss']:.4f})")
    return hist


if __name__ == "__main__":
    main()
