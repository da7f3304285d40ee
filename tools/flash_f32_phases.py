#!/usr/bin/env python3
"""Where the f32 flash kernels' cycles go, phase by phase, on one GPU:
``python3 tools/flash_f32_phases.py``.

Copies ``csrc/`` to ``build/flash_f32_phases/``, adds ``clock64()`` probes
to ``flash_attention.cu`` (thread 0 of each block adds the cycles of each
phase of each tile to a device counter; the kernels' arithmetic is
unchanged), builds the copy with the port's ``nvcc`` flags, and runs the
f32 forward and backward once at the training shape (B=1, S=4,096, 40/8
heads of 128, causal) and StarCoder2-3B's call (S=1,536, 24/2 heads).
Prints, for each kernel, its tiles (forward: 64 query rows x a key tile;
dQ: 64 rows x a key tile; dK/dV: 64 keys x a q tile) and the mean cycles
a tile spends in each phase:

* forward: [wait for the tile's copy, split K and write V^T, S = Q K^T,
  softmax, P V];
* dQ: [wait, split K and V, S and dP, dS, write K^T, dQ += dS K];
* dK/dV: [S^T and dP^T, P^T and dS^T, write dO^T and Q^T, issue dV and
  dK, split the next q tile (its wait included), dV and dK's end];

then the card's name, power limit and clocks.  Needs ``nvcc`` and a card.
"""

import ctypes
import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402

from repro_torch.kernels import _build  # noqa: E402

CSRC = ROOT / "src/repro_torch/kernels/csrc"
OUT = ROOT / "build" / "flash_f32_phases"
KERNELS = ("fwd", "dq", "dkdv")      # the counters' order
SHAPES = [(1, 4096, 40, 8, 128), (1, 1536, 24, 2, 128)]   # B, S, H, KVH, D

# device counters and the probes: thread 0 of a block adds each phase's
# cycles of each tile, and its tiles, to its kernel's counters
HEADER = """
__device__ unsigned long long g_prof[24];
__device__ unsigned long long g_prof_it[3];
#define PROF_DECL long long prof_[8] = {0, 0, 0, 0, 0, 0, 0, 0}; \\
  long long prof_t_ = clock64(); long long prof_it_ = 0;
#define PROF(n) if (tid == 0) { long long t_ = clock64(); \\
  prof_[n] += t_ - prof_t_; prof_t_ = t_; prof_it_ += (n) == 0; }
#define PROF_END(k) if (tid == 0) { for (int i_ = 0; i_ < 8; ++i_) \\
  atomicAdd(&g_prof[8 * (k) + i_], (unsigned long long)prof_[i_]); \\
  atomicAdd(&g_prof_it[k], (unsigned long long)prof_it_); }
"""
READ = """
extern "C" int repro_prof_read(void* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, g_prof, sizeof(g_prof));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaMemcpyFromSymbol((char*)out + sizeof(g_prof), g_prof_it,
                                   sizeof(g_prof_it));
}
extern "C" int repro_prof_reset() {
  unsigned long long z[27] = {};
  cudaError_t e = cudaMemcpyToSymbol(g_prof, z, sizeof(g_prof));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaMemcpyToSymbol(g_prof_it, z, sizeof(g_prof_it));
}
"""
# the probes' anchors in each kernel's loop, in order: a probe goes after
# an anchor that ends a line, before the last line of one that does not,
# and before the loop's closing brace
PROBES = {
    "fwd": [
        ("    consumers_sync();               // tile j - 1's products are "
         "in\n", None),
        ("    if (tid == 0) mbar_arrive(bar(1, j));   // the stage is free\n",
         None),
        ("    fence_regs(fs);\n    float corr[2];\n", None),
        ("    for (int i = 0; i < D / 2; ++i) acc[i] *= corr[(i >> 1) & 1];\n",
         None),
        ("    fence_regs(ps);\n  }\n", None)],
    "dq": [
        ("    consumers_sync();          // O is read, tile j - 1's products "
         "are in\n", None),
        ("    consumers_sync();\n    float s[kBK / 2], dp[kBK / 2];", None),
        ("    fence_regs(gs);\n    // dp becomes", None),
        ("    // K^T where V and V small were", None),
        ("    uint32_t db[kBK / 8][4] = {}, ds[kBK / 8][4] = {};", None),
        ("    if (lane == 0) mbar_arrive(bar(1, j));\n  }\n", None)],
    "dkdv": [
        ("    fence_regs(gs);\n\n    // P^T = exp2", None),
        ("    // the transposed B tiles", None),
        ("    if (kDv && kDk && lane == 0) mbar_arrive(bar(1, it));   "
         "// stage read\n", None),
        ("    if (kDv && kDk && it + 1 < n_it) convert(it + 1);", None),
        ("    if (kDv && kDk && it + 1 < n_it) convert(it + 1);\n"
         "    wgmma_wait<0>();", None),
        ("    if (!(kDv && kDk) && lane == 0) mbar_arrive(bar(1, it));\n  }\n",
         None)],
}
# where each kernel's loop starts (PROF_DECL before it) and ends
LOOPS = {"fwd": "  for (int j = j_lo; j < j_hi; ++j) {\n"
                "    mbar_wait(bar(0, j)",
         "dq": "  for (int j = j_lo; j < j_hi; ++j) {\n"
               "    const int k0 = j * kBK;",
         "dkdv": "  for (int it = 0; it < n_it; ++it) {\n    const int q0 = "
                 "q_start(it);"}


def _probe(text: str, k: int, name: str) -> str:
    """One kernel's source with its probes."""
    def once(t, a, b):
        if t.count(a) != 1:
            raise SystemExit(f"{name}: {a!r}: {t.count(a)} matches")
        return t.replace(a, b)
    text = once(text, LOOPS[name], "  PROF_DECL\n" + LOOPS[name])
    phase = 0
    for anchor, _ in PROBES[name]:
        last = anchor.endswith("  }\n")
        if last:                               # the loop's end
            text = once(text, anchor, anchor[:-4] + f"    PROF({phase})\n"
                        f"  }}\n  PROF_END({k})\n")
        elif anchor.endswith("\n"):            # after it
            text = once(text, anchor, anchor + f"    PROF({phase})\n")
        else:                                  # before its last line
            head, _, tail = anchor.rpartition("\n")
            text = once(text, anchor, (head + "\n" if head else "")
                        + f"    PROF({phase})\n" + tail)
        phase += 1
    return text


def build() -> ctypes.CDLL:
    """The probed copy of the f32 source, built and loaded."""
    shutil.rmtree(OUT, ignore_errors=True)
    shutil.copytree(CSRC, OUT / "csrc")
    path = OUT / "csrc" / "flash_attention.cu"
    s = path.read_text().replace('#include "hopper.cuh"\n',
                                 '#include "hopper.cuh"\n' + HEADER, 1)
    cut = [s.index(f"flash_f32_{n}(\n") for n in ("fwd", "bwd_dq",
                                                 "bwd_dkdv")]
    cut.append(s.index("// ---------------------------------------------- "
                       "backward: dK, dV of a group"))
    parts = [s[:cut[0]]] + [_probe(s[cut[i]:cut[i + 1]], i, KERNELS[i])
                            for i in range(3)] + [s[cut[3]:] + READ]
    path.write_text("".join(parts))
    nvcc = _build.find_nvcc()
    for cmd in ([nvcc, *_build.NVCC_FLAGS, "-I", str(OUT / "csrc"), "-c",
                 str(path), "-o", str(OUT / "fa.o")],
                [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
                 "-o", str(OUT / "fa.so"), str(OUT / "fa.o")]):
        r = subprocess.run(cmd, capture_output=True, text=True)
        if r.returncode:
            raise SystemExit(f"{' '.join(cmd)}:\n{r.stdout}{r.stderr}")
    lib = ctypes.CDLL(str(OUT / "fa.so"))
    for n in ("repro_flash_attention_fwd", "repro_flash_attention_bwd"):
        getattr(lib, n).argtypes = _build.SIGNATURES[n]
        getattr(lib, n).restype = ctypes.c_int
    lib.repro_prof_read.argtypes = [ctypes.c_void_p]
    return lib


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_f32_phases: no CUDA device", file=sys.stderr)
        return 1
    lib = build()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    for B, S, H, KVH, D in SHAPES:
        q, do = (torch.randn((B, S, H, D), generator=gen, device=dev)
                 for _ in range(2))
        k, v = (torch.randn((B, S, KVH, D), generator=gen, device=dev)
                for _ in range(2))
        o = torch.empty_like(q)
        lse = torch.empty((B, H, S), device=dev)
        delta = torch.empty_like(lse)
        dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
        part = torch.empty((2, B, S, H, D), device=dev)
        st = torch.cuda.current_stream(dev).cuda_stream
        strides = (*q.stride()[:3], *k.stride()[:3])

        def fwd():
            return lib.repro_flash_attention_fwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                lse.data_ptr(), B, S, S, H, KVH, D, *strides, 1, 0, 0, st)

        def bwd():
            return lib.repro_flash_attention_bwd(
                *(t.data_ptr() for t in (q, k, v, o, do, lse, delta, dq, dk,
                                         dv, part)),
                B, S, S, H, KVH, D, *strides, *o.stride()[:3],
                *do.stride()[:3], 1, 0, 0, st)

        if fwd() or bwd():
            raise SystemExit("launch failed")
        torch.cuda.synchronize(dev)
        buf = (ctypes.c_ulonglong * 27)()
        for name, fn in (("forward", fwd), ("backward", bwd)):
            lib.repro_prof_reset()
            if fn():
                raise SystemExit("launch failed")
            torch.cuda.synchronize(dev)
            lib.repro_prof_read(ctypes.cast(buf, ctypes.c_void_p))
            for i, kernel in enumerate(KERNELS):
                tiles = buf[24 + i]
                if tiles:
                    print(f"{(B, S, H, KVH, D)} {name} {kernel}: {tiles} "
                          "tiles, cycles a tile by phase",
                          [round(buf[8 * i + p] / tiles, 1)
                           for p in range(len(PROBES[kernel]))], flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,"
                          "clocks.sm,clocks.max.sm", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
