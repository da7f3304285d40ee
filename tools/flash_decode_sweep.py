#!/usr/bin/env python3
"""Route sweep of flash attention's few-row forward, and the f32 backward's
kernels, on one GPU: ``python3 tools/flash_decode_sweep.py [--iters N]``.

Builds the port's kernels (``load_library``), prints the ptxas resources of
the decode kernel's instances (``csrc/flash_decode.cu``) and of the f32
backward's kernels, then:

1. ``route``: device ms of the decode kernel (its plan's cluster size,
   ``chip_smoke._decode_fwd``) against the dtype's tile kernel
   (``flash_attention_wgmma.cu`` in bf16, ``flash_attention.cu`` in f32,
   ``chip_smoke._tile_fwd``) over 1,500 keys at three head layouts
   (``HEADS``: Whisper's 16 / 16 of 64, G = 1; StarCoder2-3B's 24 / 2 of
   128, G = 12; 40 / 8 of 128, G = 5) for Sq = 1, 2, 4, 8, 16 at B = 4
   and 1, K/V reused (L2-warm, as ``chip_smoke.py`` times it) and cycled
   over 8 layers (L2-cold, as a decode step meets them), beside SDPA.
   Each decode output is held against the tile kernel's
   (``chip_smoke._flash_close``).  Then, for each head layout, dtype and
   B, the largest Sq at which the decode kernel is no slower: the data
   for ``forward_entry``;
2. ``f32_backward``: each kernel's device ms in the f32 backward at
   StarCoder2-3B's call (24 / 2 heads of 128, S = 1,536, causal); the
   whole call, its checks and SDPA's time are ``chip_smoke.py``'s
   (``_flash_f32_shape``).

The decode kernel's checks against the plain version are
``chip_smoke.py``'s (``DECODE_CASES``, ``_decode_check``).  Prints one JSON
line per point, then the card's name and power limit.  Needs ``nvcc`` and
a card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
LAYERS = 8                     # K/V buffers a cold timing cycles through
SK = 1500                      # keys: Whisper's encoder frames
HEADS = {"whisper_16_16_d64": (16, 16, 64),
         "starcoder2_24_2_d128": (24, 2, 128),
         "gqa_40_8_d128": (40, 8, 128)}
SQS = (1, 2, 4, 8, 16)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("flash_decode_sweep: no CUDA device", file=sys.stderr)
        return 1
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=40)
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch.nn.functional as F
    from chip_smoke import (HBM_BYTES_PER_S, _decode_fwd, _flash_close,
                            _ptxas_by_kernel, _tile_fwd, time_ms)
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    _build.load_library()
    res = _ptxas_by_kernel(_build.BuildInfo.log)
    for n, r in sorted(res.items()):
        if n.startswith(("flash_decode", "flash_f32_bwd", "flash_bwd_dkdv")):
            print(json.dumps({"kernel": n, **r}), flush=True)

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(26)
    it = args.iters

    def rand(shape, dt):
        return torch.randn(shape, generator=gen, device=dev).to(dt)

    # ---- 1. route --------------------------------------------------------
    last_win = {}
    for name, (H, KVH, D) in HEADS.items():
        for dt in (torch.bfloat16, torch.float32):
            for B in (4, 1):
                layers = [(rand((B, SK, KVH, D), dt), rand((B, SK, KVH, D), dt))
                          for _ in range(LAYERS)]
                for Sq in SQS:
                    q = rand((B, Sq, H, D), dt)
                    rows = (H // KVH) * Sq
                    n = fa.plan_decode_splits(
                        0, B, KVH, rows, D,
                        fa.decode_tiles(Sq, SK, False, 0, None,
                                        fa.DECODE_TILE_ROWS[dt]), dt)
                    el = q.element_size()
                    nbytes = el * (2 * B * Sq * H * D + 2 * B * SK * KVH * D) \
                        + 4 * B * H * Sq
                    o_dec = _decode_fwd(q, *layers[0], False, 0, None, n)[0]
                    o_tile = _tile_fwd(q, *layers[0])[0]
                    torch.cuda.synchronize(dev)
                    err = _flash_close(o_dec, o_tile, False,
                                       f"{name} {dt} B{B} Sq{Sq}")
                    row = {"route": name, "dtype": str(dt).split(".")[-1],
                           "B": B, "Sq": Sq, "G": H // KVH, "rows": rows,
                           "row_groups": -(-rows // fa.decode_rows_per_block(
                               rows, D, dt)),
                           "n_splits": n, "entry": fa.forward_entry(dt, D, Sq),
                           "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                           "decode_vs_tile_err": err[0]}
                    for lbl, ls in (("warm", layers[:1]), ("cold", layers)):
                        row[f"decode_{lbl}_ms"] = time_ms(dev, [
                            lambda kv=kv: _decode_fwd(q, *kv, False, 0, None,
                                                      n) for kv in ls], it)
                        row[f"tile_{lbl}_ms"] = time_ms(
                            dev, [lambda kv=kv: _tile_fwd(q, *kv) for kv in ls],
                            it)
                        qt = q.transpose(1, 2)
                        row[f"sdpa_{lbl}_ms"] = time_ms(dev, [
                            lambda kv=kv: F.scaled_dot_product_attention(
                                qt, kv[0].transpose(1, 2),
                                kv[1].transpose(1, 2), enable_gqa=True)
                            for kv in ls], it)
                    print(json.dumps(row), flush=True)
                    key = (name, row["dtype"], B)
                    for lbl in ("warm", "cold"):
                        if row[f"decode_{lbl}_ms"] <= row[f"tile_{lbl}_ms"] \
                                and last_win.get(key + (lbl,), 0) == Sq // 2:
                            last_win[key + (lbl,)] = Sq
                        else:
                            last_win.setdefault(key + (lbl,), 0)
                del layers
                torch.cuda.empty_cache()
    for key, sq in sorted(last_win.items()):
        print(json.dumps({"route_summary": key[0], "dtype": key[1],
                          "B": key[2], "l2": key[3],
                          "decode_no_slower_up_to_sq": sq}), flush=True)

    # ---- 2. the f32 backward's kernels -------------------------------------
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    f32 = torch.float32
    B, S, H, KVH, D = 1, 1536, 24, 2, 128
    q, k, v = (rand((B, S, h, D), f32) for h in (H, KVH, KVH))
    do = rand((B, S, H, D), f32)
    o, lse = fa.flash_attention_fwd(q, k, v)
    iters = max(4, it // 4)
    fa.flash_attention_bwd(q, k, v, o, lse, do)
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fa.flash_attention_bwd(q, k, v, o, lse, do)
        torch.cuda.synchronize(dev)
    parts = {e.key[:60]: e.self_device_time_total / 1e3 / iters
             for e in prof.key_averages() if e.device_type == DeviceType.CUDA}
    print(json.dumps({"f32_backward": "starcoder2_3b", "B": B, "S": S,
                      "H": H, "KVH": KVH, "D": D,
                      "bwd_ms_by_kernel": parts}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
