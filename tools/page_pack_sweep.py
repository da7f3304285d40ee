#!/usr/bin/env python3
"""Plan sweep of the page gather / scatter kernels on one GPU:
``python3 tools/page_pack_sweep.py [--parent OLD.cu] [--iters N]``.

Builds ``csrc/page_pack.cu`` (``committed``) and, with ``--parent``, an
earlier ``page_pack.cu`` whose entry points take no plan, both ``nvcc`` at
once, into ``build/page_pack_sweep/``.  Then, at the shapes the serving
paths copy — Qwen3-14B's KV rows (160 rows of 512 KB from a 640-row pool),
H2O-Danube-1.8B's (96 rows of 320 KB) and DeepSeek-V3's latent rows (16
rows of 256 KB, ``ckv_pool``, and of 32 KB, ``krope_pool``, from 64-row
pools, cycled through enough pools to exceed twice the L2) — in two rounds
(plan order, then reversed, so the parent runs first and last): gather and
scatter device ms per call of each plan (the committed
``page_pack.copy_plan``; the word loop; bulk copies as ``piece_plan`` cuts
them with ``page_pack``'s constants set to each variant of ``BULK_PLANS``),
every result checked bit for bit against ``page_pack/ref.py``;
``torch.index_select`` / ``Tensor.index_copy_`` on the same inputs; and an
empty kernel's time measured the same way (the launch floor).  Prints one
JSON line per measurement, then the card's name and power limit.  Needs
``nvcc`` and a card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src/repro_torch/kernels/csrc/page_pack.cu"

# bulk plans: page_pack's constants for piece_plan, each variant on top of
# the committed ones (bulk_19k: the pieces at H2O-Danube's rows of a plan
# that cut pieces to give every block a ring of three)
BULK_PLANS = {"bulk_2_a_sm": {"BLOCKS_PER_SM": 2},
              "bulk_8_a_sm": {"BLOCKS_PER_SM": 8},
              "bulk_2_stages": {"STAGES": 2},
              "bulk_4_stages_16k": {"STAGES": 4, "MAX_PIECE": 16384},
              "bulk_19k": {"MAX_PIECE": 19280}}


def build(parent: str) -> dict:
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    out = ROOT / "build" / "page_pack_sweep"
    out.mkdir(parents=True, exist_ok=True)
    nvcc = _build.find_nvcc()
    jobs = {"committed": [str(SRC)]}
    if parent:
        jobs["parent"] = [parent]
    procs = {n: subprocess.Popen(
        [nvcc, *_build.NVCC_FLAGS, "-shared", "-o", str(out / f"{n}.so"),
         *args], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for n, args in jobs.items()}
    libs = {}
    for n, p in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            raise SystemExit(f"nvcc failed on {n}:\n{log}")
        lib = ctypes.CDLL(str(out / f"{n}.so"))
        for fn in ("repro_page_gather", "repro_page_scatter"):
            sig = _build.SIGNATURES[fn]
            getattr(lib, fn).argtypes = sig if n != "parent" \
                else sig[:6] + sig[-1:]
            getattr(lib, fn).restype = ctypes.c_int
        if n != "parent":
            lib.repro_empty_launch.argtypes = _build.SIGNATURES[
                "repro_empty_launch"]
            lib.repro_empty_launch.restype = ctypes.c_int
        libs[n] = lib
    return libs


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("page_pack_sweep: no CUDA device", file=sys.stderr)
        return 1
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", default="",
                    help="an earlier page_pack.cu to time beside")
    ap.add_argument("--iters", type=int, default=40)
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from chip_smoke import L2_BYTES, HBM_BYTES_PER_S, _slot_rows, time_ms
    from repro_torch.kernels.page_pack import page_pack as pk
    from repro_torch.kernels.page_pack.ref import (page_gather_ref,
                                                   page_scatter_ref)

    libs = build(args.parent)
    dev = torch.device("cuda", 0)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    stream = torch.cuda.current_stream(dev).cuda_stream
    bf16 = torch.bfloat16
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    # name: (layers, pool rows a layer, rows a slot, row elements)
    shapes = {"qwen3_kv": (40, 16, 4, 256 * 8 * 128),
              "danube_kv": (24, 8, 4, 256 * 8 * 80),
              "ckv_pool": (4, 16, 4, 256 * 512),
              "krope_pool": (4, 16, 4, 256 * 64)}
    for name, (L, P, per, E) in shapes.items():
        rows = L * P
        n_pools = max(1, -(-2 * L2_BYTES // (rows * E * 2)))
        if name.endswith("_kv"):
            n_pools = 1           # 335 / 63 MB: one pool, two blocks alternate
        pools = [torch.randn((rows, E), generator=gen, device=dev).to(bf16)
                 for _ in range(n_pools)]
        idx = _slot_rows(L, P, per, 1, dev)
        n = idx.numel()
        blocks = [torch.randn((n, E), generator=gen, device=dev).to(bf16)
                  for _ in range(max(2, n_pools))]
        pairs = [(pools[i % n_pools], blocks[i]) for i in range(len(blocks))]
        row_bytes = E * 2
        bound = (2 * n * row_bytes + 4 * n) / HBM_BYTES_PER_S * 1e3
        il = idx.long()

        def call(lib, op, pool, blk, plan):
            fn = lib.repro_page_gather if op == "gather" \
                else lib.repro_page_scatter
            a = (pool.data_ptr(), idx.data_ptr(), blk.data_ptr(), row_bytes,
                 n, rows)
            code = fn(*a, *plan, stream) if plan else fn(*a, stream)
            if code != 0:
                raise RuntimeError(f"{op} launch failed: {code}")

        def plan_of(variant, plan_name):
            if variant == "parent":
                return None
            if plan_name == "copy_plan":
                return pk.copy_plan(n, row_bytes, n_sm)
            if plan_name == "words":
                return (pk.WORDS, 0, 0, 0)
            consts = {k: getattr(pk, k) for k in BULK_PLANS[plan_name]}
            try:
                for k, v in BULK_PLANS[plan_name].items():
                    setattr(pk, k, v)
                return (pk.BULK,) + pk.piece_plan(n, row_bytes, n_sm) + (
                    pk.STAGES,)
            finally:
                for k, v in consts.items():
                    setattr(pk, k, v)

        def measure(variant, plan_name, rnd):
            lib = libs[variant]
            plan = plan_of(variant, plan_name)
            pool, blk = pairs[0]
            res = {"shape": name, "variant": variant, "plan": plan_name,
                   "mode_piece_blocks": plan, "round": rnd}
            for op in ("gather", "scatter"):
                p2 = pool.clone() if op == "scatter" else pool
                call(lib, op, p2, blk, plan)
                torch.cuda.synchronize(dev)
                want = page_gather_ref(pool, idx) if op == "gather" else \
                    page_scatter_ref(pool.clone(), idx, blk)
                got = blk if op == "gather" else p2
                if not torch.equal(got, want):
                    raise SystemExit(f"{variant} {plan_name} {name} {op}: "
                                     "differs from ref.py")
                del p2
                res[f"{op}_ms"] = time_ms(dev, [
                    lambda p=p, b=b: call(lib, op, p, b, plan)
                    for p, b in pairs], args.iters)
            res["bound_ms"] = bound
            print(json.dumps(res), flush=True)

        order = [("committed", p)
                 for p in ("copy_plan", "words", *BULK_PLANS)]
        if "parent" in libs:
            order.insert(0, ("parent", None))
        for rnd, seq in enumerate((order, order[::-1])):
            for v, p in seq:
                measure(v, p, rnd)
            lib_ms = {
                "index_select_ms": time_ms(dev, [
                    lambda p=p, b=b: torch.index_select(p, 0, il, out=b)
                    for p, b in pairs], args.iters),
                "index_copy_ms": time_ms(dev, [
                    lambda p=p, b=b: p.index_copy_(0, il, b)
                    for p, b in pairs], args.iters)}
            for blocks_ in sorted({pk.copy_plan(n, row_bytes, n_sm)[2]
                                   or n * -(-row_bytes // 16384), 1}):
                lib_ms[f"empty_kernel_{blocks_}_blocks_ms"] = time_ms(dev, [
                    lambda: libs["committed"].repro_empty_launch(blocks_,
                                                                 stream)],
                    args.iters)
            print(json.dumps({"shape": name, "round": rnd, **lib_ms,
                              "bound_ms": bound}), flush=True)
        del pools, blocks, pairs
        torch.cuda.empty_cache()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
