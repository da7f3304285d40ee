#!/usr/bin/env python3
"""Do the bf16 flash kernels give the bits an earlier source gave?
``python3 tools/flash_bits_check.py --parent DIR``.

Builds ``csrc/flash_attention_tc.cu`` of the tree at ``DIR`` (an earlier
checkout, for example ``git archive <commit> src | tar -x -C DIR``) into
``build/flash_bits/parent.so``, and this tree's into ``current.so``, both
with the port's ``nvcc`` flags; runs each, and this tree's bindings
(``flash_attention_fwd`` / ``flash_attention_bwd`` at ``q_offset = 0``),
on ``chip_smoke.BF16_BITS_CASES`` from the same seed; prints the sha256 of
each one's o, lse, dq, dk and dv (``chip_smoke.bf16_bits``), whether they
agree, and the card's name and power limit.  ``chip_smoke.BF16_BITS``
holds the parent's digest.  Needs ``nvcc`` and a card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
TC = Path("src/repro_torch/kernels/csrc/flash_attention_tc.cu")


def build(sources: dict) -> dict:
    """name -> the (fwd, bwd) C entry points of that source's library."""
    from repro_torch.kernels import _build
    out = ROOT / "build" / "flash_bits"
    out.mkdir(parents=True, exist_ok=True)
    nvcc = _build.find_nvcc()
    procs = {n: subprocess.Popen(
        [nvcc, *_build.NVCC_FLAGS, "-I", str(src.parent), "-shared", "-o",
         str(out / f"{n}.so"), str(src)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for n, src in sources.items()}
    libs = {}
    for n, p in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            raise SystemExit(f"nvcc failed on {n}:\n{log}")
        lib = ctypes.CDLL(str(out / f"{n}.so"))
        fns = []
        for name in ("repro_flash_attention_tc_fwd",
                     "repro_flash_attention_tc_bwd"):
            fn = getattr(lib, name)
            fn.argtypes = _build.SIGNATURES[name]
            fn.restype = ctypes.c_int
            fns.append(fn)
        libs[n] = tuple(fns)
    return libs


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("flash_bits_check: no CUDA device", file=sys.stderr)
        return 1
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True,
                    help="root of the earlier tree (holds src/repro_torch)")
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from chip_smoke import BF16_BITS, bf16_bits
    from repro_torch.kernels._build import check_launch
    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention_bwd, flash_attention_fwd)

    dev = torch.device("cuda", 0)
    libs = build({"parent": Path(args.parent) / TC, "current": ROOT / TC})

    def calls(fwd_fn, bwd_fn):
        def fwd(q, k, v, causal, window):
            B, S, H, D = q.shape
            o = torch.empty_like(q)
            lse = torch.empty((B, H, S), dtype=torch.float32, device=dev)
            check_launch(fwd_fn(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                lse.data_ptr(), B, S, S, H, k.shape[2], D, *q.stride()[:3],
                *k.stride()[:3], int(causal), window, 0,
                torch.cuda.current_stream(dev).cuda_stream), "fwd")
            return o, lse

        def bwd(q, k, v, o, lse, dout, causal, window):
            B, S, H, D = q.shape
            delta = torch.empty((B, H, S), dtype=torch.float32, device=dev)
            dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
            check_launch(bwd_fn(
                *(t.data_ptr() for t in (q, k, v, o, dout, lse, delta, dq, dk,
                                         dv)), B, S, S, H, k.shape[2], D,
                int(causal), window, 0,
                torch.cuda.current_stream(dev).cuda_stream), "bwd")
            return dq, dk, dv
        return fwd, bwd

    got = {n: bf16_bits(dev, *calls(*fns)) for n, fns in libs.items()}
    got["bindings"] = bf16_bits(
        dev, lambda q, k, v, c, w: flash_attention_fwd(
            q, k, v, causal=c, window=w, q_offset=0),
        lambda q, k, v, o, lse, do, c, w: flash_attention_bwd(
            q, k, v, o, lse, do, causal=c, window=w, q_offset=0))
    print(json.dumps({"sha256": got, "all_equal": len(set(got.values())) == 1,
                      "chip_smoke_BF16_BITS": BF16_BITS,
                      "torch": torch.__version__}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
