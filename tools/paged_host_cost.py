#!/usr/bin/env python3
"""Host cost of one paged-attention call on one GPU:
``python3 tools/paged_host_cost.py [--src DIR] [--serve]``.

Imports ``repro_torch`` from ``DIR`` (default: this checkout's ``src/``),
so an earlier tree unpacked beside this one is measured by the same
script; run it on both trees in turns in one session on the card and
compare.  The shape is the serving path's decode attention of Qwen3-14B
(bf16, B=4, H=40, KVH=8, D=128, 256-token pages, lengths
204/307/614/1024), calls cycling through 8 layers' pools.  Per call:

* ``wrapper_us``: host time of ``ops.paged_attention``, the serving
  path's call (checks, plan, C entry point, launch), by ``perf_counter``
  around ``BATCH`` calls with no synchronisation among them; the device
  is synchronised between batches, and a batch is short enough that the
  launch queue never fills (a full queue would make the host wait for the
  device, and the time that of the kernel).  Median and least of
  ``ROUNDS`` batches;
* ``c_entry_us``: the same for the C entry point alone, its arguments
  prepared beforehand (for the split kernel: the tensor maps' encoding and
  the launch);
* ``cuda_event_ms``: CUDA events around 2,000 of the wrapper's calls (the
  larger of host and device time);
* ``kernel_ms``: the kernels' own time from ``torch.profiler``.

``--serve`` then runs ``chip_smoke.py``'s ``serve`` phase (full-width
Qwen3-14B, its requests and undersized pool) and its batch-1 decode-step
profile with that tree's package, each printing its own JSON line, so the
end-to-end wall time and a step's wall and device time of two trees can be
compared in one session.

Prints one JSON line, then the card's name and power limit.  Builds the
tree's kernels into its own ``build/`` at first use; needs ``nvcc``.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
BATCH = 100        # calls between synchronisations: ~6 ms of the parent's
ROUNDS = 40        # kernels, far from a full launch queue


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the directory that holds repro_torch")
    ap.add_argument("--serve", action="store_true",
                    help="also run chip_smoke.py's serve phase and profile")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("paged_host_cost: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, args.src)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import _build
    from repro_torch.kernels.paged_attention import paged_attention as pa
    from repro_torch.kernels.paged_attention.ops import paged_attention

    dev = torch.device("cuda", 0)
    B, H, KVH, D, ps, NP, L = 4, 40, 8, 128, 256, 4, 8
    G = H // KVH
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    bf16 = torch.bfloat16
    kp = torch.randn((L, B * NP, ps, KVH, D), generator=gen,
                     device=dev).to(bf16)
    vp = torch.randn((L, B * NP, ps, KVH, D), generator=gen,
                     device=dev).to(bf16)
    q = torch.randn((B, H, D), generator=gen, device=dev).to(bf16)
    pt = torch.arange(B * NP, dtype=torch.int32, device=dev).reshape(B, NP)
    ln = torch.tensor([204, 307, 614, 1024], dtype=torch.int32, device=dev)

    def wrapper(i):
        return paged_attention(q, kp[i % L], vp[i % L], pt, ln)

    # the C entry point with its arguments ready; the split kernel's
    # signature adds P (after D) and n_splits (after window), the row
    # copies' seg (after ps)
    fn = _build.load_library().repro_paged_attention
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(dev).cuda_stream
    n_args = len(_build.SIGNATURES["repro_paged_attention"])
    split = n_args >= 20
    seg = (pa.bulk_segment(ps, D, bf16),) if n_args == 21 else ()
    sp, st, sh, _ = kp[0].stride()
    n = pa.plan_splits(0, B, KVH, G, D, NP, ps, bf16) if split else None
    c_args = []
    for layer in range(L):
        head = (q.data_ptr(), kp[layer].data_ptr(), vp[layer].data_ptr(),
                pt.data_ptr(), ln.data_ptr(), out.data_ptr(), B, KVH, G, D)
        c_args.append(head + ((B * NP,) if split else ()) +
                      (NP, ps) + seg + (sp, st, sh, 0) +
                      ((n,) if split else ()) +
                      (1, stream))

    def c_entry(i):
        code = fn(*c_args[i % L])
        if code != 0:
            raise RuntimeError(f"paged_attention launch failed: {code}")

    ref = wrapper(0)
    c_entry(0)
    torch.cuda.synchronize(dev)
    if not torch.equal(out, ref):
        raise SystemExit("paged_host_cost: the C entry point and the "
                         "wrapper disagree")

    def host_us(f):
        per = []
        for _ in range(ROUNDS):
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            for i in range(BATCH):
                f(i)
            per.append((time.perf_counter() - t0) * 1e6 / BATCH)
        torch.cuda.synchronize(dev)
        return statistics.median(per), min(per)

    result = {"src": args.src, "split_kernel": split, "n_splits": n,
              "batch": BATCH, "rounds": ROUNDS}
    for f in (wrapper, c_entry):         # warm-up
        host_us(f)
    for name, f in (("wrapper", wrapper), ("c_entry", c_entry)):
        result[f"{name}_us_median"], result[f"{name}_us_least"] = host_us(f)
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(2000):
        wrapper(i)
    stop.record()
    torch.cuda.synchronize(dev)
    result["cuda_event_ms"] = start.elapsed_time(stop) / 2000
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(200):
            wrapper(i)
        torch.cuda.synchronize(dev)
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA)
    result["kernel_ms"] = us / 1e3 / 200
    print(json.dumps(result), flush=True)
    del kp, vp
    if args.serve:
        sys.path.insert(1, str(ROOT))
        import chip_smoke
        from repro_torch.configs import get_config
        sz = chip_smoke.Sizes()
        params, cfg = chip_smoke.phase_serve(dev, sz, get_config(sz.arch), [])
        chip_smoke.phase_profile(dev, sz, cfg, params, steps=8)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
