#!/usr/bin/env python3
"""The bf16 flash forward of an earlier tree against this tree's, on one
GPU: ``python3 tools/flash_tc_sweep.py --parent DIR [--variants a,b]
[--iters N]``.

Builds the parent tree's forward (``DIR`` is an earlier checkout, for
example ``git archive <commit> src | tar -x -C DIR``; its
``csrc/flash_attention_tc.cu`` held the ``mma.sync`` forward before the
wgmma one), this tree's (``csrc/flash_attention_wgmma.cu``) and the
``VARIANTS`` named, each a copy of this tree's source with one piece of
its design taken out by a text substitution; all ``nvcc`` at once with
the port's flags, into ``build/flash_tc_sweep/``; prints each kernel's
ptxas resources.  Then, at the shapes of ``SHAPES`` (the training paths'
forwards: Qwen3-14B at D = 128, DeepSeek-V3's MLA at D = 192, Zamba2-7B at
D = 112, Whisper-medium's cross and encoder attention, and ranks 0, 8 and
15 of Qwen3-14B's sequence split over 16 ranks), each forward is timed in
turns (parent, current, the variants, then in reverse) beside SDPA:
device ms per call from ``chip_smoke.time_ms`` (torch.profiler), the
host's microseconds per call of the C entry (this tree's encodes three
tensor maps a call), the bound (FLOPs at the card's bf16 rate or bytes at
its memory rate, K and V over the keys the rows reach), and each output's
largest row error against the parent's.  One JSON line per shape, then
the card's name and power limit.  Needs ``nvcc`` and a card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CSRC = Path("src/repro_torch/kernels/csrc")
ENTRY = "repro_flash_attention_tc_fwd"

# this tree's source with one piece of the design taken out: (old, new)
# text substitutions, each of which must match once
VARIANTS = {
    # the two warpgroups issue their products whenever they are ready
    "no_ping_pong": [
        ("auto my_turn = [&]() { named_sync(1 + wg, 2 * 128); };",
         "auto my_turn = [&]() {};"),
        ("auto your_turn = [&]() { named_arrive(2 - wg, 2 * 128); };",
         "auto your_turn = [&]() {};")],
    # every (batch, head) pair in one group: the latest q tiles of all
    # heads first
    "heads_together": [("constexpr long long kL2Budget = 32ll << 20;",
                        "constexpr long long kL2Budget = 1ll << 62;")],
    # groups of one pair: a head's q tiles one after the other
    "one_head_at_a_time": [("constexpr long long kL2Budget = 32ll << 20;",
                            "constexpr long long kL2Budget = 0;")],
    # a ring of two stages
    "two_stages": [("static constexpr int kStages = kFit < 4 ? kFit : 4;",
                    "static constexpr int kStages = 2;")],
}

# name: B, Sq, Sk, H, KVH, D, causal, q_offset
SHAPES = {
    "qwen3_14b_d128": (1, 4096, 4096, 40, 8, 128, True, 0),
    "deepseek_v3_d192": (1, 4096, 4096, 128, 128, 192, True, 0),
    "zamba2_7b_d112": (1, 4096, 4096, 32, 32, 112, True, 0),
    "whisper_cross": (8, 448, 1500, 16, 16, 64, False, 0),
    "whisper_encoder": (8, 1500, 1500, 16, 16, 64, False, 0),
    "seq_split_rank0": (1, 256, 4096, 40, 8, 128, True, 0),
    "seq_split_rank8": (1, 256, 4096, 40, 8, 128, True, 8 * 256),
    "seq_split_rank15": (1, 256, 4096, 40, 8, 128, True, 15 * 256),
}


def variant_source(subs) -> str:
    text = (ROOT / CSRC / "flash_attention_wgmma.cu").read_text()
    for old, new in subs:
        if text.count(old) != 1:
            raise SystemExit(f"{old!r}: {text.count(old)} matches")
        text = text.replace(old, new)
    return text


def build(parent: Path, variants: list) -> dict:
    """name -> (library, nvcc log) of the parent's forward source, this
    tree's and each variant's."""
    from repro_torch.kernels import _build
    out = ROOT / "build" / "flash_tc_sweep"
    out.mkdir(parents=True, exist_ok=True)
    nvcc = _build.find_nvcc()
    srcs = {"parent": parent / CSRC / "flash_attention_tc.cu",
            "current": ROOT / CSRC / "flash_attention_wgmma.cu"}
    for v in variants:
        srcs[v] = out / f"{v}.cu"
        srcs[v].write_text(variant_source(VARIANTS[v]))
    procs = {}
    for n, src in srcs.items():
        inc = ROOT / CSRC if n in variants else src.parent  # flash_mask.cuh
        procs[n] = subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-I", str(inc), "-shared", "-o",
             str(out / f"{n}.so"), str(src)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
    libs = {}
    for n, p in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            raise SystemExit(f"nvcc failed on {n}:\n{log}")
        lib = ctypes.CDLL(str(out / f"{n}.so"))
        fn = getattr(lib, ENTRY)
        fn.argtypes = _build.SIGNATURES[ENTRY]
        fn.restype = ctypes.c_int
        libs[n] = (fn, log)
    return libs


def main() -> int:
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("flash_tc_sweep: no CUDA device", file=sys.stderr)
        return 1
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True,
                    help="root of the earlier tree (holds src/repro_torch)")
    ap.add_argument("--variants", default="",
                    help=f"comma-separated, of {', '.join(VARIANTS)}")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--shapes", default=",".join(SHAPES))
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from chip_smoke import (HBM_BYTES_PER_S, PEAK_FLOPS, _ptxas_by_kernel,
                            _row_rel_err, _split_keys, _split_pairs,
                            time_ms)
    from repro_torch.kernels._build import check_launch
    variants = [v for v in args.variants.split(",") if v]
    libs = build(Path(args.parent), variants)
    for n, (_, log) in libs.items():
        print(json.dumps({"tree": n, "ptxas": _ptxas_by_kernel(log)}),
              flush=True)

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    for name in args.shapes.split(","):
        B, Sq, Sk, H, KVH, D, causal, off = SHAPES[name]
        q, k, v = rand(B, Sq, H, D), rand(B, Sk, KVH, D), rand(B, Sk, KVH, D)
        o = torch.empty_like(q)
        lse = torch.empty((B, H, Sq), dtype=torch.float32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream

        def call(fn):
            check_launch(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                            o.data_ptr(), lse.data_ptr(), B, Sq, Sk, H, KVH,
                            D, *q.stride()[:3], *k.stride()[:3], int(causal),
                            0, off, stream), name)

        def host_us(fn, n=50):
            call(fn)
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            for _ in range(n):
                call(fn)
            us = (time.perf_counter() - t0) * 1e6 / n
            torch.cuda.synchronize(dev)
            return us

        outs = {}
        for n, (fn, _) in libs.items():
            call(fn)
            torch.cuda.synchronize(dev)
            outs[n] = o.clone()
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        if off:
            pos = off + torch.arange(Sq, device=dev)[:, None]
            mask = pos >= torch.arange(Sk, device=dev)[None, :]
            sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
                qt, kt, vt, attn_mask=mask, enable_gqa=True)
        else:
            sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
                qt, kt, vt, is_causal=causal, enable_gqa=True)
        names = list(libs)
        ms = {n: [] for n in names + ["sdpa"]}
        hus = {n: [] for n in names}
        with torch.no_grad():
            for n in names + names[::-1]:
                fn = libs[n][0]
                ms[n].append(time_ms(dev, [lambda: call(fn)], args.iters))
                hus[n].append(host_us(fn))
                ms["sdpa"].append(time_ms(dev, [sdpa], args.iters))
        pairs = B * (_split_pairs(Sk, off, off + Sq, True, 0) if causal
                     else Sq * Sk)
        flops = 4 * H * D * pairs
        # read once / written once: q and o, K and V over the keys the rows
        # reach (chip_smoke's seq_split bound), lse
        keys = _split_keys(Sk, off, off + Sq, causal, 0)
        nbytes = 2 * (2 * B * Sq * H * D + 2 * B * keys * KVH * D) \
            + 4 * B * H * Sq
        bound = max(flops / PEAK_FLOPS["bfloat16"],
                    nbytes / HBM_BYTES_PER_S) * 1e3
        med = {n: statistics.median(x) for n, x in ms.items()}
        print(json.dumps({
            "shape": name, "B": B, "Sq": Sq, "Sk": Sk, "H": H, "KVH": KVH,
            "D": D, "causal": causal, "q_offset": off,
            "ms": ms, "median_ms": med, "bound_ms": bound,
            "bound_share_current": bound / med["current"],
            "current_over_sdpa": med["current"] / med["sdpa"],
            "current_over_parent": med["current"] / med["parent"],
            "host_us_per_call": hus,
            "row_rel_err_vs_parent": {n: _row_rel_err(outs[n],
                                                      outs["parent"])
                                      for n in names[1:]},
            "finite": all(bool(torch.isfinite(outs[n].float()).all())
                          for n in names),
            "blocks_current": H * B * math.ceil(Sq / 128)}), flush=True)
        del q, k, v, o, lse, outs, qt, kt, vt
        torch.cuda.empty_cache()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
