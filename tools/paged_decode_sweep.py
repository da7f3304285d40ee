#!/usr/bin/env python3
"""Variant sweep of the split-KV paged-attention kernel on one GPU:
``python3 tools/paged_decode_sweep.py [--parent OLD.cu] [--iters N]``.

Builds ``csrc/paged_attention.cu`` once per variant of its compile-time
knobs — rows a ring stage (``REPRO_PA_TILE_BF16``: 32, 64, 128) × stages
(``REPRO_PA_STAGES``: 2, 3, 4) — all ``nvcc`` at once, into
``build/paged_decode_sweep/``, each built to accept clusters of 16
(``REPRO_PA_MAX_SPLITS=16``: non-portable; the port's own build stops at
8).  Each variant runs at every cluster size (1, 2, 4, 8, 16) on three
bf16 shapes of Qwen3-14B's decode attention (H=40, KVH=8, D=128,
256-token pages): the serving batch (B=4, lengths 204/307/614/1024), one
sequence of 1024, and one at the native context of 32,768 tokens.  Device ms per call (the kernels' time from
``torch.profiler``; CUDA events beside it) over calls that cycle through
8 layers' pools (L2-cold, as in a decode step), in two rounds (variant
order, then reversed); each output against the plain version.
``--parent`` also times an earlier kernel source with the C signature
that has no ``n_splits`` (one block per (kv_head, batch)).  Prints one
JSON line per variant, shape, cluster size and round, then the best point
per shape beside the plan's, each kernel's ptxas resources and the card's
name and power limit.  Needs ``nvcc`` and a card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src/repro_torch/kernels/csrc/paged_attention.cu"
TILES = (32, 64, 128)
STAGES = (2, 3, 4)
CLUSTERS = (1, 2, 4, 8, 16)
COMMITTED = "t64_s4"           # the source's own defaults


def variants() -> dict:
    return {f"t{t}_s{s}": (t, s) for t in TILES for s in STAGES}


def build(names: dict, parent) -> dict:
    from repro_torch.kernels import _build
    out = ROOT / "build" / "paged_decode_sweep"
    out.mkdir(parents=True, exist_ok=True)
    nvcc = _build.find_nvcc()
    procs = {}
    for n, (t, s) in names.items():
        cmd = [nvcc, *_build.NVCC_FLAGS, f"-DREPRO_PA_TILE_BF16={t}",
               f"-DREPRO_PA_STAGES={s}",
               f"-DREPRO_PA_MAX_SPLITS={max(CLUSTERS)}", "-shared", "-o",
               str(out / f"{n}.so"), str(SRC)]
        procs[n] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
    if parent:
        cmd = [nvcc, *_build.NVCC_FLAGS, "-shared", "-o",
               str(out / "parent.so"), str(parent)]
        procs["parent"] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT, text=True)
    libs = {}
    sig = _build.SIGNATURES["repro_paged_attention"]
    for n, p in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            raise SystemExit(f"nvcc failed on {n}:\n{log}")
        lib = ctypes.CDLL(str(out / f"{n}.so"))
        fn = lib.repro_paged_attention
        # the parent (a split kernel from before the row copies) has no
        # seg (the fourteenth)
        fn.argtypes = sig if n != "parent" else sig[:13] + sig[14:]
        fn.restype = ctypes.c_int
        libs[n] = (fn, log)
    return libs


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("paged_decode_sweep: no CUDA device", file=sys.stderr)
        return 1
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", default="",
                    help="an earlier paged_attention.cu to time beside")
    ap.add_argument("--iters", type=int, default=40)
    args = ap.parse_args()
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from chip_smoke import _ptxas_by_kernel
    from repro_torch.kernels.paged_attention.paged_attention import (
        bulk_segment, plan_splits)
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref

    libs = build(variants(), args.parent)
    for n, (_, log) in libs.items():
        res = _ptxas_by_kernel(log).get("paged_attention_kernel<bf16,128,5>")
        print(json.dumps({"variant": n, "consts": variants().get(n),
                          "ptxas_bf16_d128": res}), flush=True)

    dev = torch.device("cuda", 0)
    H, KVH, D, ps, L = 40, 8, 128, 256, 8
    bf16 = torch.bfloat16
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    shapes = {"serving_b4": (4, 4, [204, 307, 614, 1024]),
              "serving_b1": (1, 4, [1024]),
              "long_context": (1, 128, [32768])}
    data = {}
    for name, (B, NP, lens) in shapes.items():
        kp = torch.randn((L, B * NP, ps, KVH, D), generator=gen,
                         device=dev).to(bf16)
        vp = torch.randn((L, B * NP, ps, KVH, D), generator=gen,
                         device=dev).to(bf16)
        q = torch.randn((B, H, D), generator=gen, device=dev).to(bf16)
        pt = torch.arange(B * NP, dtype=torch.int32,
                          device=dev).reshape(B, NP)
        ln = torch.tensor(lens, dtype=torch.int32, device=dev)
        ref = paged_attention_ref(q, kp[0], vp[0], pt, ln)
        nbytes = (2 * sum(lens) * KVH * D + 2 * B * H * D) * 2 \
            + pt.numel() * 4 + B * 4
        data[name] = (q, kp, vp, pt, ln, ref, nbytes / 3.35e12 * 1e3)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def call(n, fn, name, layer, splits, out):
        q, kp, vp, pt, ln, _, _ = data[name]
        B, _, _ = q.shape
        k, v = kp[layer], vp[layer]
        sp, st, sh, _ = k.stride()
        seg = () if n == "parent" else (bulk_segment(ps, D, bf16),)
        return fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), pt.data_ptr(),
                  ln.data_ptr(), out.data_ptr(), B, KVH, H // KVH, D,
                  k.shape[0], pt.shape[1], ps, *seg, sp, st, sh, 0, splits,
                  1, stream)

    def measure(n, fn, name, splits):
        q, _, _, _, _, ref, bound = data[name]
        out = torch.empty_like(q)
        code = call(n, fn, name, 0, splits, out)
        torch.cuda.synchronize(dev)
        if code != 0:
            return {"refused": code}
        err = float((out.float() - ref.float()).abs().max())
        for i in range(L):
            call(n, fn, name, i, splits, out)
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(args.iters):
            call(n, fn, name, i % L, splits, out)
        stop.record()
        torch.cuda.synchronize(dev)
        events_ms = start.elapsed_time(stop) / args.iters
        # the host's ctypes call can outlast a 10 us kernel, so the events
        # may time the host: the kernels' own device time decides
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for i in range(args.iters):
                call(n, fn, name, i % L, splits, out)
            torch.cuda.synchronize(dev)
        us = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA)
        ms = us / 1e3 / args.iters if us > 0 else events_ms
        return {"ms": ms, "cuda_event_ms": events_ms, "bound_ms": bound,
                "bound_share": bound / ms, "max_abs_err": err}

    order = list(libs)
    best = {}
    for rnd, names in enumerate((order, order[::-1])):
        for n in names:
            fn = libs[n][0]
            for name in shapes:
                for splits in ((1,) if n == "parent" else CLUSTERS):
                    r = measure(n, fn, name, splits)
                    print(json.dumps({"round": rnd, "variant": n,
                                      "shape": name, "n_splits": splits,
                                      **r}), flush=True)
                    if "ms" in r and n != "parent":
                        key = (name, n, splits)
                        best[key] = best.get(key, 0.0) + r["ms"] / 2
    for name, (B, NP, _) in shapes.items():
        pts = sorted((ms, n, s) for (sh, n, s), ms in best.items()
                     if sh == name)
        at_plan = plan_splits(0, B, KVH, H // KVH, D, NP, ps, bf16)
        if pts:
            print(json.dumps({"best": name, "ms_mean_of_rounds": pts[0][0],
                              "variant": pts[0][1], "n_splits": pts[0][2],
                              "plan_n_splits": at_plan, "committed_at_plan":
                              best.get((name, COMMITTED, at_plan))}),
                  flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
