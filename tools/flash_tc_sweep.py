#!/usr/bin/env python3
"""Tile-size sweep of the bf16 tensor-core flash-attention kernels on one
GPU: ``python3 tools/flash_tc_sweep.py [--variants a,b,...]``.

Builds ``csrc/flash_attention_tc.cu`` once per variant (a variant rewrites
some of the source's tile constants; ``committed`` is the source as it
is), all variants' ``nvcc`` at once, into ``build/flash_tc_sweep/``.  Then,
at the training shape (B=1, S=4096, H=40, KVH=8, D=128, bf16, causal), in
two rounds (variant order, then reversed): forward and backward device ms
per call, each kernel by name from ``torch.profiler``, and every variant's
o, dq, dk, dv against the committed source's (largest relative L2 error of
one row).  Prints one JSON line per variant and round, each kernel's ptxas
resources, and the card's name and power limit.  Needs ``nvcc`` and a card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src/repro_torch/kernels/csrc/flash_attention_tc.cu"

# each variant's tile constants, as rewritten in the source; "committed"
# rewrites nothing.  Forward: warps, m16 tiles a warp, keys a tile, blocks
# an SM (launch bounds); dQ: keys a tile, blocks an SM; dK/dV: q rows a tile.
VARIANTS = {
    "committed": {},
    "fwd_8w_m1_bk64_2_blocks": {"kFwdBK": 64, "kFwdMinBlocks": 2},
    "fwd_8w_m1_bk64_1_block": {"kFwdBK": 64, "kFwdMinBlocks": 1},
    "fwd_4w_m2_bk64_2_blocks": {"kFwdWarps": 4, "kFwdM": 2, "kFwdBK": 64,
                                "kFwdMinBlocks": 2},
    "fwd_8w_m2_bk64_1_block": {"kFwdM": 2, "kFwdBK": 64},
    "fwd_4w_m2_bk32_2_blocks": {"kFwdWarps": 4, "kFwdM": 2, "kFwdBK": 32,
                                "kFwdMinBlocks": 2},
    "dq_bk32_2_blocks": {"kDqBK": 32, "kDqMinBlocks": 2},
    "dkdv_bq32": {"kKvBQ": 32},
}


def variant_source(consts: dict) -> str:
    text = SRC.read_text()
    for name, val in consts.items():
        text, n = re.subn(rf"constexpr int {name} = [^;]+;",
                          f"constexpr int {name} = {val};", text)
        if n != 1:
            raise SystemExit(f"{name}: {n} definitions in {SRC.name}")
    return text


def build(names: list) -> dict:
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    out = ROOT / "build" / "flash_tc_sweep"
    out.mkdir(parents=True, exist_ok=True)
    nvcc = _build.find_nvcc()
    procs = {}
    for n in names:
        cu = out / f"{n}.cu"
        cu.write_text(variant_source(VARIANTS[n]))
        cmd = [nvcc, *_build.NVCC_FLAGS, "-shared", "-o", str(out / f"{n}.so"),
               str(cu)]
        procs[n] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
    libs = {}
    for n, p in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            raise SystemExit(f"nvcc failed on {n}:\n{log}")
        lib = ctypes.CDLL(str(out / f"{n}.so"))
        for fn in ("repro_flash_attention_tc_fwd",
                   "repro_flash_attention_tc_bwd"):
            getattr(lib, fn).argtypes = _build.SIGNATURES[fn]
            getattr(lib, fn).restype = ctypes.c_int
        libs[n] = (lib, log)
    return libs


def main() -> int:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    if not torch.cuda.is_available():
        print("flash_tc_sweep: no CUDA device", file=sys.stderr)
        return 1
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()
    names = args.variants.split(",")
    if names[0] != "committed":
        names.insert(0, "committed")
    sys.path.insert(0, str(ROOT))
    from chip_smoke import _ptxas_by_kernel
    libs = build(names)
    for n, (_, log) in libs.items():
        res = {k: v for k, v in _ptxas_by_kernel(log).items()
               if k.endswith("<128>")}
        print(json.dumps({"variant": n, "consts": VARIANTS[n],
                          "ptxas_d128": res}), flush=True)

    dev = torch.device("cuda", 0)
    B, S, H, KVH, D = 1, 4096, 40, 8, 128
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    q, k, v, dout = rand(B, S, H, D), rand(B, S, KVH, D), rand(B, S, KVH, D), \
        rand(B, S, H, D)
    stream = lambda: torch.cuda.current_stream(dev).cuda_stream

    def fwd(lib):
        o = torch.empty_like(q)
        lse = torch.empty((B, H, S), dtype=torch.float32, device=dev)
        code = lib.repro_flash_attention_tc_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), B, S, H, KVH, D, *q.stride()[:3], *k.stride()[:3],
            1, 0, stream())
        assert code == 0, code
        return o, lse

    def bwd(lib, o, lse):
        delta = torch.empty((B, H, S), dtype=torch.float32, device=dev)
        dq, dk, dv = torch.empty_like(q), torch.empty_like(k), \
            torch.empty_like(v)
        code = lib.repro_flash_attention_tc_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), B, S, H, KVH, D, 1, 0, stream())
        assert code == 0, code
        return dq, dk, dv

    def row_rel(a, b):
        a, b = a.float(), b.float()
        floor = 5e-4 * math.sqrt(b.shape[-1])
        return float(((a - b).norm(dim=-1) / b.norm(dim=-1).clamp_min(floor))
                     .max())

    def timed(fn, iters):
        fn()
        torch.cuda.synchronize(dev)
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        stop.record()
        torch.cuda.synchronize(dev)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize(dev)
        by_kernel = {e.key[:60]: e.self_device_time_total / 1e3 / iters
                     for e in prof.key_averages()
                     if e.device_type == DeviceType.CUDA}
        return start.elapsed_time(stop) / iters, by_kernel

    base = None
    for rnd, order in enumerate((names, names[::-1])):
        for n in order:
            lib = libs[n][0]
            o, lse = fwd(lib)
            grads = bwd(lib, o, lse)
            torch.cuda.synchronize(dev)
            if base is None:
                base = (o, *grads)
            errs = {name: row_rel(a, b) for name, a, b in
                    zip(("o", "dq", "dk", "dv"), (o, *grads), base)}
            fwd_ms, fwd_k = timed(lambda: fwd(lib), args.iters)
            bwd_ms, bwd_k = timed(lambda: bwd(lib, o, lse), args.iters)
            print(json.dumps({"variant": n, "round": rnd,
                              "fwd_ms_events": fwd_ms,
                              "bwd_ms_events": bwd_ms,
                              "fwd_kernels_ms": fwd_k,
                              "bwd_kernels_ms": bwd_k,
                              "row_rel_err_vs_committed": errs}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
