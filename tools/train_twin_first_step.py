#!/usr/bin/env python3
"""What the training twin's first step pays for, part by part:
``python3 tools/train_twin_first_step.py [--steps 3]``.

Builds ``examples/torch_train_demand_paged.py``'s model, optimizer and
loss at the example's defaults (Qwen3-14B cut to 52.4M f32 parameters,
host-paged AdamW, 2 microbatches with remat) on one GPU and times, on
the host's clock with the device synchronised after each part: the
import of torch, the CUDA context, the port's modules, the two modules
a training step imports on its first call (``torch.distributed.tensor``
for the port's DTensor checks, ``torch._dynamo`` for
``torch.utils.checkpoint``), the kernel library (built into ``build/``
if it is not there; needs ``nvcc``), the first matmul, the parameters
and the optimizer, then each step's ``value_and_grad`` and optimizer
update.  Run it twice in a row to see a cold process beside a warm one.

One JSON line (seconds by part, in order), then the card's name and
power limit.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=3)
    args = ap.parse_args()
    parts: dict = {}
    last = [T0]

    def mark(what: str) -> None:
        import torch
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
        now = time.perf_counter()
        parts[what] = now - last[0]
        last[0] = now

    import torch
    mark("import torch")
    if not torch.cuda.is_available():
        print("train_twin_first_step: no CUDA device", file=sys.stderr)
        return 1
    torch.zeros(1, device="cuda")
    mark("cuda context")
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.kernels import _build
    from repro_torch.memory.offload import PagedAdamW
    from repro_torch.models.config import reduced
    from repro_torch.models.registry import model_for
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.optim.schedules import cosine_with_warmup
    from repro_torch.training.trainer import (TrainConfig, make_loss_fn,
                                              value_and_grad)
    mark("import repro_torch")
    import torch.distributed.tensor  # noqa: F401
    mark("import torch.distributed.tensor")
    import torch._dynamo  # noqa: F401
    mark("import torch._dynamo")
    _build.load_library()
    mark("kernel library (build or load)")
    a = torch.randn(512, 512, device="cuda")
    a @ a
    mark("first matmul")
    cfg = reduced(get_config("qwen3_14b"), n_layers=6, d_model=512,
                  head_dim=64, n_heads=8, n_kv_heads=4, d_ff=1536,
                  vocab_size=32768, dtype="float32")
    params = model_for(cfg).init_params(cfg, 0)
    opt_cfg = AdamWConfig(lr=3e-4, schedule=cosine_with_warmup(3e-4, 30,
                                                               300))
    opt = PagedAdamW(opt_cfg, params, block_elems=1 << 21)
    loss_fn = make_loss_fn(cfg, TrainConfig(microbatches=2, remat=True,
                                            optimizer=opt_cfg))
    ds = SyntheticLM(cfg.vocab_size, seq_len=64, batch_per_shard=8)
    mark("parameters, optimizer, loss")
    for step in range(args.steps):
        tokens, labels = (torch.from_numpy(x).cuda()
                          for x in ds.batch_at(step))
        loss, grads = value_and_grad(loss_fn, params, tokens, labels)
        mark(f"step {step + 1} value_and_grad")
        params = opt.update(params, grads)
        mark(f"step {step + 1} optimizer update")
        if not torch.isfinite(loss):
            print(f"train_twin_first_step: loss {float(loss)}",
                  file=sys.stderr)
            return 1
    print(json.dumps({"seconds": parts, "total": sum(parts.values())}),
          flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
