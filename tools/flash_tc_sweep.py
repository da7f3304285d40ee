#!/usr/bin/env python3
"""The flash kernels of one route of an earlier tree against this tree's,
on one GPU: ``python3 tools/flash_tc_sweep.py --parent DIR [--dtype
bfloat16|float32] [--variants a,b] [--iters N] [--turns N] [--shapes
a,b]``.

Builds, for the parent tree (``DIR`` is an earlier checkout, for example
``git archive <commit> src | tar -x -C DIR``), for this tree and for each
of the ``VARIANTS`` named, the ``csrc/*.cu`` sources that hold the
route's entry points (bf16: ``repro_flash_attention_tc_fwd`` / ``_bwd``;
f32: ``repro_flash_attention_fwd`` / ``_bwd``, wherever the tree keeps
them) into one library each, under ``build/flash_tc_sweep/``
(a variant is a copy of this tree's ``csrc/`` with one piece of the
design taken out by text substitutions in its sources or headers); all
``nvcc`` at once with the port's flags; prints each kernel's ptxas
resources.  Then, at the shapes of ``SHAPES`` (bf16: the training paths'
flash calls: Qwen3-14B at D = 128, DeepSeek-V3's MLA at D = 192,
Zamba2-7B at D = 112, Whisper-medium's cross and encoder attention, and
ranks 0, 8 and 15 of Qwen3-14B's sequence split over 16 ranks, and the
last ranks of H2O-Danube-1.8B's at head dim 80 and of Mixtral-8x7B's with
its window) or ``F32_SHAPES`` (f32: the training shape, StarCoder2-3B's
whole call and ranks 0, 8 and 15 of its split, ``train_parity``'s call,
the training example's), each tree's forward and
backward are timed in turns (parent, current, the variants, then in
reverse, ``--turns`` in all), each turn beside SDPA's forward and its
autograd backward:
device ms per call from ``chip_smoke.time_ms`` (torch.profiler), the
parent's and this tree's backward by kernel (dQ and dK/dV apart), the
host's microseconds per forward call of the C entry, the bounds (FLOPs
at the card's bf16 rate, in f32 at the tensor cores' rate for three TF32
products a product with the CUDA cores' bound beside it, or bytes at its
memory rate; K and V over the keys the rows reach), and each output's
largest row error against the
parent's (the backward of every tree takes this tree's forward's o and
lse).  One JSON line per shape, then the card's name and power limit.
Needs ``nvcc`` and a card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CSRC = Path("src/repro_torch/kernels/csrc")
# the route's entry points, by dtype
ENTRIES = {"bfloat16": ("repro_flash_attention_tc_fwd",
                        "repro_flash_attention_tc_bwd"),
           "float32": ("repro_flash_attention_fwd",
                       "repro_flash_attention_bwd")}

# this tree's sources with one piece of the design taken out: (file, old,
# new) text substitutions, each of which must match once
VARIANTS = {
    # the two warpgroups issue their products whenever they are ready
    "no_ping_pong": [("hopper.cuh", "named_sync(1 + wg, 2 * 128);", ""),
                     ("hopper.cuh", "named_arrive(2 - wg, 2 * 128);", "")],
    # every pair in one group: the heaviest tiles of all heads first
    "heads_together": [("hopper.cuh",
                        "constexpr long long kL2Budget = 32ll << 20;",
                        "constexpr long long kL2Budget = 1ll << 62;")],
    # groups of one pair (one KV head's query heads in dQ)
    "one_head_at_a_time": [("hopper.cuh",
                            "constexpr long long kL2Budget = 32ll << 20;",
                            "constexpr long long kL2Budget = 0;")],
    # rings of two stages
    "two_stages": [("flash_attention_wgmma.cu",
                    "static constexpr int kStages = kFit < 4 ? kFit : 4;",
                    "static constexpr int kStages = 2;"),
                   ("flash_attention_wgmma_bwd.cu",
                    "constexpr int kMaxStages = 4;",
                    "constexpr int kMaxStages = 2;")],
    # f32: rings of one stage
    "f32_one_stage": [("flash_attention.cu", "constexpr int kMaxStages = 4;",
                       "constexpr int kMaxStages = 1;")],
    # f32: two register sets for a JIT-split A operand, one k step's
    # products in flight while the next is split (not two)
    "f32_two_sets": [("flash_attention.cu", "constexpr int kSets = 3;",
                      "constexpr int kSets = 2;")],
    # f32: dQ splits Q and dO into registers a k step at a time as it
    # reads them (as at D = 192), not once a block into shared memory
    "f32_dq_split_each_step": [("flash_attention.cu",
                                "      / (2 * kKVBytes) >= 2;",
                                "      / (2 * kKVBytes) >= 99;")],
    # f32: the forward at D = 128 on 32-key tiles, Q split once into
    # shared memory (it fits beside them, with three stages)
    "f32_fwd_32_keys": [("flash_attention.cu", "X(128, 64, 32, 32)",
                         "X(128, 32, 32, 32)")],
}

# name: B, Sq, Sk, H, KVH, D, causal, q_offset, window
SHAPES = {
    "qwen3_14b_d128": (1, 4096, 4096, 40, 8, 128, True, 0, 0),
    "deepseek_v3_d192": (1, 4096, 4096, 128, 128, 192, True, 0, 0),
    "zamba2_7b_d112": (1, 4096, 4096, 32, 32, 112, True, 0, 0),
    "whisper_cross": (8, 448, 1500, 16, 16, 64, False, 0, 0),
    "whisper_encoder": (8, 1500, 1500, 16, 16, 64, False, 0, 0),
    "seq_split_rank0": (1, 256, 4096, 40, 8, 128, True, 0, 0),
    "seq_split_rank8": (1, 256, 4096, 40, 8, 128, True, 8 * 256, 0),
    "seq_split_rank15": (1, 256, 4096, 40, 8, 128, True, 15 * 256, 0),
    # the other seq_split shapes' last (heaviest) ranks: H2O-Danube-1.8B
    # at head dim 80 (the 128 instance) and Mixtral-8x7B with its window
    "danube_d80_rank15": (1, 256, 4096, 32, 8, 80, True, 15 * 256, 0),
    "mixtral_window_rank15": (1, 512, 8192, 32, 8, 128, True, 15 * 512,
                              4096),
}
# the f32 route's calls: the training shape (chip_smoke's f32 training
# shape), StarCoder2-3B's whole call and ranks 0, 8 and 15 of its split
# over 16 ranks (chip_smoke's seq_split f32 case), train_parity's call
# (Qwen3-14B's heads, a batch of 2 x 512) and the training example's
F32_SHAPES = {
    "training_shape": (1, 4096, 4096, 40, 8, 128, True, 0, 0),
    "starcoder2_whole": (1, 1536, 1536, 24, 2, 128, True, 0, 0),
    "starcoder2_rank0": (1, 96, 1536, 24, 2, 128, True, 0, 0),
    "starcoder2_rank8": (1, 96, 1536, 24, 2, 128, True, 8 * 96, 0),
    "starcoder2_rank15": (1, 96, 1536, 24, 2, 128, True, 15 * 96, 0),
    "train_parity": (2, 512, 512, 40, 8, 128, True, 0, 0),
    "training_example": (4, 64, 64, 8, 4, 64, True, 0, 0),
}


def entry_sources(csrc: Path, entries) -> list:
    """The sources under ``csrc`` that define the route's entry points."""
    pat = re.compile(r'extern "C" int (%s|%s)\(' % tuple(entries))
    return [p for p in sorted(csrc.glob("*.cu")) if pat.search(p.read_text())]


def variant_csrc(name: str, out: Path) -> Path:
    """A copy of this tree's ``csrc/`` with the variant's substitutions."""
    dst = out / name / "csrc"
    if dst.exists():
        shutil.rmtree(dst)
    shutil.copytree(ROOT / CSRC, dst)
    for fname, old, new in VARIANTS[name]:
        text = (dst / fname).read_text()
        if text.count(old) != 1:
            raise SystemExit(f"{name}: {fname}: {old!r}: {text.count(old)} "
                             "matches")
        (dst / fname).write_text(text.replace(old, new))
    return dst


def build(parent: Path, variants: list, entries) -> dict:
    """name -> (forward, backward, strided backward?, nvcc log) of the
    parent's sources, this tree's and each variant's."""
    from repro_torch.kernels import _build
    from tools.flash_bits_check import bwd_argtypes
    out = ROOT / "build" / "flash_tc_sweep"
    out.mkdir(parents=True, exist_ok=True)
    nvcc = _build.find_nvcc()
    trees = {"parent": parent / CSRC, "current": ROOT / CSRC}
    for v in variants:
        trees[v] = variant_csrc(v, out)
    procs = []
    for name, csrc in trees.items():
        for src in entry_sources(csrc, entries):
            obj = out / f"{name}_{src.stem}.o"
            procs.append((name, obj, subprocess.Popen(
                [nvcc, *_build.NVCC_FLAGS, "-I", str(csrc), "-c", str(src),
                 "-o", str(obj)], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)))
    objs = {name: [] for name in trees}
    logs = {name: "" for name in trees}
    for name, obj, p in procs:
        log, _ = p.communicate()
        if p.returncode != 0:
            raise SystemExit(f"nvcc failed on {obj.name}:\n{log}")
        objs[name].append(str(obj))
        logs[name] += log
    libs = {}
    for name, csrc in trees.items():
        so = out / f"{name}.so"
        r = subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                            "-shared", "-o", str(so), *objs[name]],
                           capture_output=True, text=True)
        if r.returncode != 0:
            raise SystemExit(f"link failed for {name}:\n{r.stdout}{r.stderr}")
        lib = ctypes.CDLL(str(so))
        fwd, bwd = (getattr(lib, e) for e in entries)
        fwd.argtypes = _build.SIGNATURES[entries[0]]
        bwd.argtypes = bwd_argtypes(entry_sources(csrc, entries), entries[1])
        fwd.restype = bwd.restype = ctypes.c_int
        libs[name] = (fwd, bwd, ctypes.c_longlong in bwd.argtypes,
                      logs[name])
    return libs


def bwd_by_kernel(dev, fn, iters: int) -> dict:
    """Device ms a call of each kernel ``fn`` launches (its name without
    template arguments: dQ and dK/dV apart), from one torch.profiler
    session over ``iters`` calls."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) \
            as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize(dev)
    out = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            m = re.search(r"flash_[a-z0-9_]+", e.key)
            name = m.group(0) if m else e.key
            out[name] = out.get(name, 0.0) + e.self_device_time_total \
                / 1e3 / iters
    return out


def main() -> int:
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("flash_tc_sweep: no CUDA device", file=sys.stderr)
        return 1
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True,
                    help="root of the earlier tree (holds src/repro_torch)")
    ap.add_argument("--dtype", default="bfloat16", choices=tuple(ENTRIES),
                    help="the route: bf16 or f32")
    ap.add_argument("--variants", default="",
                    help=f"comma-separated, of {', '.join(VARIANTS)}")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--turns", type=int, default=2,
                    help="turns of each tree (even: in order, then in "
                    "reverse); the medians are over them")
    ap.add_argument("--shapes", default="",
                    help="comma-separated, of SHAPES (bf16) or F32_SHAPES "
                    "(f32); all of them by default")
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from chip_smoke import (_bound, _ptxas_by_kernel, _row_rel_err,
                            _split_keys, _split_pairs, time_ms)
    from repro_torch.kernels._build import check_launch
    f32 = args.dtype == "float32"
    dtype = torch.float32 if f32 else torch.bfloat16
    # SDPA's f32 products in f32, as chip_smoke's yardsticks
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    shapes = F32_SHAPES if f32 else SHAPES
    variants = [v for v in args.variants.split(",") if v]
    libs = build(Path(args.parent), variants, ENTRIES[args.dtype])
    for n, lib in libs.items():
        print(json.dumps({"tree": n, "ptxas": _ptxas_by_kernel(lib[3])}),
              flush=True)

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    for name in (args.shapes or ",".join(shapes)).split(","):
        B, Sq, Sk, H, KVH, D, causal, off, window = shapes[name]
        q, k, v = rand(B, Sq, H, D), rand(B, Sk, KVH, D), rand(B, Sk, KVH, D)
        dout = rand(B, Sq, H, D)
        o = torch.empty_like(q)
        lse = torch.empty((B, H, Sq), dtype=torch.float32, device=dev)
        delta = torch.empty_like(lse)
        grads = [torch.empty_like(t) for t in (q, k, v)]
        # f32: the query heads' dK, dV terms (G > 1), held for the shape
        scratch = torch.empty((2, B, Sk, H, D), dtype=torch.float32,
                              device=dev) if f32 and H > KVH else None
        part = [scratch.data_ptr() if scratch is not None else None] \
            if f32 else []
        stream = torch.cuda.current_stream(dev).cuda_stream

        def fwd_call(lib, out=o, stats=lse):
            check_launch(lib[0](q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                out.data_ptr(), stats.data_ptr(), B, Sq, Sk,
                                H, KVH, D, *q.stride()[:3], *k.stride()[:3],
                                int(causal), window, off, stream), name)

        def bwd_call(lib):
            strides = (*q.stride()[:3], *k.stride()[:3], *o.stride()[:3],
                       *dout.stride()[:3]) if lib[2] else ()
            check_launch(lib[1](
                *(t.data_ptr() for t in (q, k, v, o, dout, lse, delta,
                                         *grads)), *part,
                B, Sq, Sk, H, KVH, D, *strides, int(causal), window, off,
                stream), name)

        def host_us(fn, n=50):
            fn()
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            us = (time.perf_counter() - t0) * 1e6 / n
            torch.cuda.synchronize(dev)
            return us

        names = list(libs)
        outs, gouts = {}, {}
        scratch_o = torch.empty_like(o)
        scratch_lse = torch.empty_like(lse)
        fwd_call(libs["current"])               # the backward's o and lse
        for n in names:
            fwd_call(libs[n], scratch_o, scratch_lse)
            bwd_call(libs[n])
            torch.cuda.synchronize(dev)
            outs[n] = scratch_o.clone()
            gouts[n] = [g.clone() for g in grads]
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True)
                      for t in (q, k, v))
        if off or window:
            pos = off + torch.arange(Sq, device=dev)[:, None]
            key = torch.arange(Sk, device=dev)[None, :]
            mask = pos >= key
            if window:
                mask &= pos - key < window
            kw = dict(attn_mask=mask, enable_gqa=True)
        else:
            kw = dict(is_causal=causal, enable_gqa=True)
        with torch.no_grad():
            sdpa_fwd = lambda: F.scaled_dot_product_attention(  # noqa: E731
                qt, kt, vt, **kw)
        sdpa_out = F.scaled_dot_product_attention(qt, kt, vt, **kw)
        dout_t = dout.transpose(1, 2)

        def sdpa_bwd():
            torch.autograd.grad(sdpa_out, (qt, kt, vt), dout_t,
                                retain_graph=True)

        ms = {f"{n}_{p}": [] for n in names + ["sdpa"] for p in ("fwd", "bwd")}
        hus = {n: [] for n in names}
        for n in (names + names[::-1]) * max(1, args.turns // 2):
            lib = libs[n]
            with torch.no_grad():
                ms[f"{n}_fwd"].append(time_ms(
                    dev, [lambda: fwd_call(lib, scratch_o, scratch_lse)],
                    args.iters))
                ms[f"{n}_bwd"].append(time_ms(dev, [lambda: bwd_call(lib)],
                                              args.iters))
                hus[n].append(host_us(lambda: fwd_call(lib, scratch_o,
                                                       scratch_lse)))
                ms["sdpa_fwd"].append(time_ms(dev, [sdpa_fwd], args.iters))
            ms["sdpa_bwd"].append(time_ms(dev, [sdpa_bwd], args.iters))
        by_kernel = {n: bwd_by_kernel(dev, lambda: bwd_call(libs[n]),
                                      args.iters)
                     for n in ("parent", "current")}
        pairs = B * (_split_pairs(Sk, off, off + Sq, True, window) if causal
                     else Sq * Sk)
        keys = _split_keys(Sk, off, off + Sq, causal, window)

        # read once / written once: q, o (and dout, dq), K and V over the
        # keys the rows reach (and dk, dv over all Sk), lse (and delta)
        el = q.element_size()
        fwd_b = _bound(4 * H * D * pairs,
                       el * (2 * B * Sq * H * D + 2 * B * keys * KVH * D)
                       + 4 * B * H * Sq, dtype)
        bwd_b = _bound(10 * H * D * pairs,
                       el * (4 * B * Sq * H * D + 2 * B * keys * KVH * D
                             + 2 * B * Sk * KVH * D) + 8 * B * H * Sq,
                       dtype)
        fwd_bound, bwd_bound = fwd_b["bound_ms"], bwd_b["bound_ms"]
        rows = 64 if f32 else 128
        med = {n: statistics.median(x) for n, x in ms.items()}
        print(json.dumps({
            "shape": name, "B": B, "Sq": Sq, "Sk": Sk, "H": H, "KVH": KVH,
            "D": D, "causal": causal, "q_offset": off, "window": window,
            "ms": ms, "median_ms": med,
            "dtype": args.dtype,
            "fwd_bound_ms": fwd_bound, "bwd_bound_ms": bwd_bound,
            "fwd_bound_cuda_cores_ms": fwd_b.get("bound_cuda_cores_ms"),
            "bwd_bound_cuda_cores_ms": bwd_b.get("bound_cuda_cores_ms"),
            "fwd_bound_share_current": fwd_bound / med["current_fwd"],
            "bwd_bound_share_current": bwd_bound / med["current_bwd"],
            "fwd_current_over_sdpa": med["current_fwd"] / med["sdpa_fwd"],
            "bwd_current_over_sdpa": med["current_bwd"] / med["sdpa_bwd"],
            "fwd_current_over_parent": med["current_fwd"]
            / med["parent_fwd"],
            "bwd_current_over_parent": med["current_bwd"]
            / med["parent_bwd"],
            "host_us_per_fwd_call": hus,
            "bwd_ms_by_kernel": by_kernel,
            "fwd_row_rel_err_vs_parent": {
                n: _row_rel_err(outs[n], outs["parent"]) for n in names[1:]},
            "bwd_row_rel_err_vs_parent": {
                n: max(_row_rel_err(a, b) for a, b in
                       zip(gouts[n], gouts["parent"])) for n in names[1:]},
            "finite": all(bool(torch.isfinite(t.float()).all())
                          for n in names for t in [outs[n], *gouts[n]]),
            "blocks_current": {
                "fwd": H * B * math.ceil(Sq / rows),
                "bwd_dq": H * B * math.ceil(Sq / rows),
                "bwd_dkdv": (H if f32 and H > KVH else KVH) * B
                * math.ceil(Sk / rows)}}),
            flush=True)
        del q, k, v, o, lse, delta, grads, outs, gouts, qt, kt, vt, sdpa_out
        del scratch
        torch.cuda.empty_cache()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
