#!/usr/bin/env python3
"""Do the flash kernels give the bits an earlier source gave?
``python3 tools/flash_bits_check.py --parent DIR``.

Builds, for the tree at ``DIR`` (an earlier checkout, for example
``git archive <commit> src | tar -x -C DIR``) and for this tree, the
``csrc/*.cu`` sources that hold the flash entry points (the bf16 route's
``repro_flash_attention_tc_fwd`` / ``_bwd`` and the f32 route's
``repro_flash_attention_fwd`` / ``_bwd``, wherever each tree keeps them)
into ``build/flash_bits/parent.so`` and ``current.so``, all ``nvcc`` at
once with the port's flags (a tree whose backward entry, of either route,
takes the operands' strides is called with them, an older one without).
Then, on
``chip_smoke.BF16_BITS_CASES`` from one seed (``chip_smoke.bf16_bits``),
prints the sha256 of

* ``bf16_forward``: o and lse of each tree's bf16 forward and of this
  tree's binding (``flash_attention_fwd`` at ``q_offset = 0``), which
  ``chip_smoke.BF16_FWD_BITS`` holds;
* ``bf16``: o, lse, dq, dk and dv of each tree's kernels and of this
  tree's bindings (``flash_attention_bwd`` too).  ``chip_smoke.BF16_BITS``
  holds this tree's digest;
* ``bf16_backward_at_parent_forward``: dq, dk and dv of each tree's
  backward given the parent's forward's o and lse, so a change to the
  forward alone leaves them equal and a change to the backward moves
  them;
* ``float32``: the same cases in f32 through each tree's f32 route,
  forward and backward (3xTF32 on wgmma since the f32 route's redesign, on
  the CUDA cores before: its digest moves there);

whether each agrees, and the card's name and power limit.  Needs ``nvcc``
and a card.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CSRC = Path("src/repro_torch/kernels/csrc")
ENTRIES = ("repro_flash_attention_tc_fwd", "repro_flash_attention_tc_bwd",
           "repro_flash_attention_fwd", "repro_flash_attention_bwd")


def entry_sources(tree: Path) -> list:
    """The tree's sources that define one of ``ENTRIES``."""
    pat = re.compile(r'extern "C" int (%s)\(' % "|".join(ENTRIES))
    return [p for p in sorted((tree / CSRC).glob("*.cu"))
            if pat.search(p.read_text())]


def bwd_argtypes(sources: list,
                 entry: str = "repro_flash_attention_tc_bwd") -> list:
    """The ctypes argtypes of the backward ``entry`` (the bf16 route's or
    the f32 route's ``repro_flash_attention_bwd``) that ``sources``
    define: with the operands' twelve strides after the six ints (the
    wgmma backwards) or, for an older tree whose entry takes them
    contiguous, without."""
    from repro_torch.kernels import _build
    sig = _build.SIGNATURES[entry]
    ints = sig.index(ctypes.c_int) + 6          # past B .. D
    for src in sources:
        head = src.read_text().partition(f'extern "C" int {entry}(')
        if head[1]:
            strided = "long long" in head[2].split(")", 1)[0]
            return sig if strided else sig[:ints] + sig[ints + 12:]
    raise SystemExit(f"no {entry} in {sources}")


def build(trees: dict) -> dict:
    """name -> the library of that tree's entry sources, with the four
    entry points' argtypes set."""
    from repro_torch.kernels import _build
    out = ROOT / "build" / "flash_bits"
    out.mkdir(parents=True, exist_ok=True)
    nvcc = _build.find_nvcc()
    procs = []
    for name, tree in trees.items():
        for src in entry_sources(tree):
            obj = out / f"{name}_{src.stem}.o"
            procs.append((name, obj, subprocess.Popen(
                [nvcc, *_build.NVCC_FLAGS, "-I", str(src.parent), "-c",
                 str(src), "-o", str(obj)], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)))
    objs = {name: [] for name in trees}
    for name, obj, p in procs:
        log, _ = p.communicate()
        if p.returncode != 0:
            raise SystemExit(f"nvcc failed on {obj.name}:\n{log}")
        objs[name].append(str(obj))
    libs = {}
    for name in trees:
        so = out / f"{name}.so"
        r = subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                            "-shared", "-o", str(so), *objs[name]],
                           capture_output=True, text=True)
        if r.returncode != 0:
            raise SystemExit(f"link failed for {name}:\n{r.stdout}{r.stderr}")
        lib = ctypes.CDLL(str(so))
        for fn in ENTRIES:
            getattr(lib, fn).argtypes = _build.SIGNATURES[fn]
            getattr(lib, fn).restype = ctypes.c_int
        for entry in ENTRIES[1::2]:
            getattr(lib, entry).argtypes = bwd_argtypes(
                entry_sources(trees[name]), entry)
        libs[name] = lib
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
    from chip_smoke import (BF16_BITS, BF16_BITS_CASES, BF16_FWD_BITS,
                            _rand, bf16_bits)
    from repro_torch.kernels._build import check_launch
    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention_bwd, flash_attention_fwd)

    dev = torch.device("cuda", 0)
    trees = {"parent": Path(args.parent), "current": ROOT}
    libs = build(trees)
    stream = lambda: torch.cuda.current_stream(dev).cuda_stream  # noqa: E731

    def calls(lib, f32: bool):
        fwd_fn = lib.repro_flash_attention_fwd if f32 \
            else lib.repro_flash_attention_tc_fwd
        bwd_fn = lib.repro_flash_attention_bwd if f32 \
            else lib.repro_flash_attention_tc_bwd

        def fwd(q, k, v, causal, window):
            B, S, H, D = q.shape
            o = torch.empty_like(q)
            lse = torch.empty((B, H, S), dtype=torch.float32, device=dev)
            check_launch(fwd_fn(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                lse.data_ptr(), B, S, S, H, k.shape[2], D, *q.stride()[:3],
                *k.stride()[:3], int(causal), window, 0, stream()), "fwd")
            return o, lse

        def bwd(q, k, v, o, lse, dout, causal, window):
            B, S, H, D = q.shape
            KVH = k.shape[2]
            delta = torch.empty((B, H, S), dtype=torch.float32, device=dev)
            dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
            ptrs = [t.data_ptr() for t in (q, k, v, o, dout, lse, delta, dq,
                                           dk, dv)]
            strides = ()
            if f32:              # the query heads' dK, dV terms (G > 1)
                part = torch.empty((2, B, S, H, D), dtype=torch.float32,
                                   device=dev) if H > KVH else None
                ptrs.append(None if part is None else part.data_ptr())
            if ctypes.c_longlong in bwd_fn.argtypes:   # takes strides
                strides = (*q.stride()[:3], *k.stride()[:3],
                           *o.stride()[:3], *dout.stride()[:3])
            check_launch(bwd_fn(*ptrs, B, S, S, H, KVH, D, *strides,
                                int(causal), window, 0, stream()), "bwd")
            return dq, dk, dv
        return fwd, bwd

    def backward_at(fwd_src, bwd_lib) -> str:
        """dq, dk, dv of ``bwd_lib``'s bf16 backward given ``fwd_src``'s
        forward's o and lse, on the cases' inputs."""
        fwd = calls(fwd_src, False)[0]
        bwd = calls(bwd_lib, False)[1]
        gen = torch.Generator(device=dev)
        gen.manual_seed(26)
        h = hashlib.sha256()
        for (B, S, H, KVH, D, causal, window) in BF16_BITS_CASES:
            q = _rand(gen, (B, S, H, D), torch.bfloat16, dev)
            k, v = (_rand(gen, (B, S, KVH, D), torch.bfloat16, dev)
                    for _ in range(2))
            dout = _rand(gen, (B, S, H, D), torch.bfloat16, dev)
            o, lse = fwd(q, k, v, causal, window)
            for t in bwd(q, k, v, o, lse, dout, causal, window):
                h.update(t.view(torch.uint8).cpu().numpy().tobytes())
        return h.hexdigest()

    pairs = {n: bf16_bits(dev, *calls(lib, False))
             for n, lib in libs.items()}
    pairs["bindings"] = bf16_bits(
        dev, lambda q, k, v, c, w: flash_attention_fwd(
            q, k, v, causal=c, window=w, q_offset=0),
        lambda q, k, v, o, lse, do, c, w: flash_attention_bwd(
            q, k, v, o, lse, do, causal=c, window=w, q_offset=0))
    fwd = {n: p[0] for n, p in pairs.items()}
    bf16 = {n: p[1] for n, p in pairs.items()}
    at_parent = {n: backward_at(libs["parent"], lib)
                 for n, lib in libs.items()}
    f32 = {n: bf16_bits(dev, *calls(lib, True), dtype=torch.float32)[1]
           for n, lib in libs.items()}
    print(json.dumps({
        "sources": {n: [p.name for p in entry_sources(t)]
                    for n, t in trees.items()},
        "bf16_forward": fwd,
        "bf16_forward_unchanged": len(set(fwd.values())) == 1,
        "bf16": bf16,
        "bf16_current_equals_bindings": bf16["current"] == bf16["bindings"],
        "bf16_current_equals_parent": bf16["current"] == bf16["parent"],
        "bf16_backward_at_parent_forward": at_parent,
        "bf16_backward_unchanged": len(set(at_parent.values())) == 1,
        "float32": f32, "float32_unchanged": len(set(f32.values())) == 1,
        "chip_smoke_BF16_FWD_BITS": BF16_FWD_BITS,
        "chip_smoke_BF16_FWD_BITS_is_current": BF16_FWD_BITS == fwd[
            "current"],
        "chip_smoke_BF16_BITS": BF16_BITS,
        "chip_smoke_BF16_BITS_is_current": BF16_BITS == bf16["current"],
        "torch": torch.__version__}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
