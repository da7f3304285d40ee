"""Build and load the port's CUDA kernels (``csrc/*.cu``) at first use.

Each source is compiled by ``nvcc`` for ``sm_90a`` into an object file —
all sources at once, one compiler process each — and the objects are
linked into **one** shared library with a plain C interface, which is
loaded with ``ctypes``.  No PyTorch header is involved, so the build takes
seconds.  The library goes into ``build/`` at the repository root, under a
name derived from the sources' contents, so an unchanged tree loads the
library it built before and a changed source rebuilds.

Nothing here runs at import: :func:`load_library` is called by a kernel
wrapper the first time it launches.  A failing build raises
:class:`KernelCompileError` with the compiler's output; there is no fallback.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
SIGNATURES = {
    # q, k_pool, v_pool, page_table, lengths, out, B, KVH, G, D, P, NP, ps,
    # seg, stride_p, stride_t, stride_h, window, n_splits, dtype_code, stream
    "repro_paged_attention": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                              _I, _I, _LL, _LL, _LL, _I, _I, _I, _P],
    # n_splits, D, G, dtype_code, *count
    "repro_paged_attention_active_clusters": [_I, _I, _I, _I,
                                              ctypes.POINTER(_I)],
    # pool, indices, block, row_bytes, n, pool_rows, mode, piece, blocks,
    # stages, stream
    "repro_page_gather": [_P, _P, _P, _LL, _I, _I, _I, _I, _I, _I, _P],
    "repro_page_scatter": [_P, _P, _P, _LL, _I, _I, _I, _I, _I, _I, _P],
    # blocks, stream
    "repro_empty_launch": [_I, _P],
    # q, k, v, o, lse, B, Sq, Sk, H, KVH, D, sq_b, sq_s, sq_h, sk_b, sk_s,
    # sk_h, causal, window, stream: f32 on the CUDA cores, bf16 on the
    # tensor cores
    **dict.fromkeys(
        ("repro_flash_attention_fwd", "repro_flash_attention_tc_fwd"),
        [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _LL, _LL, _LL, _LL,
         _LL, _LL, _I, _I, _P]),
    # q, k, v, o, dout, lse, delta, dq, dk, dv, B, Sq, Sk, H, KVH, D, causal,
    # window, stream
    **dict.fromkeys(
        ("repro_flash_attention_bwd", "repro_flash_attention_tc_bwd"),
        [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
         _I, _P]),
}


class KernelCompileError(RuntimeError):
    """nvcc is missing or refused a source."""


class BuildInfo:
    """What the last :func:`load_library` did (read by ``chip_smoke.py``)."""
    path: Optional[Path] = None
    seconds: float = 0.0
    cached: bool = False
    log: str = ""            # nvcc / ptxas output (-Xptxas -v resource lines)


_LIB: Optional[ctypes.CDLL] = None
_LOCK = threading.Lock()      # one build at a time; a second caller waits


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def build_dir() -> Path:
    # src/repro_torch/kernels/_build.py -> repository root
    return Path(__file__).resolve().parents[3] / "build"


def find_nvcc() -> str:
    cands = [shutil.which("nvcc")]
    for var in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(var):
            cands.append(os.path.join(os.environ[var], "bin", "nvcc"))
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise KernelCompileError(
        "nvcc not found (looked on PATH, in $CUDA_HOME/bin and in "
        "/usr/local/cuda/bin); the CUDA kernels cannot be built")


def _digest(srcs: list[Path]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    return h.hexdigest()[:16]


def _compile(srcs: list[Path], out: Path) -> str:
    """Compile every source in parallel, link, return the compilers' log."""
    nvcc = find_nvcc()
    work = out.parent / f"{out.stem}.{os.getpid()}.tmp"
    work.mkdir(parents=True, exist_ok=True)
    try:
        procs = []
        for s in srcs:
            obj = work / (s.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(s), "-o", str(obj)]
            procs.append((s, obj, cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        log, failed = [], []
        for s, obj, cmd, p in procs:
            text, _ = p.communicate()
            log.append(f"$ {' '.join(cmd)}\n{text}")
            if p.returncode != 0:
                failed.append(s.name)
        if failed:
            raise KernelCompileError(
                f"nvcc failed on {', '.join(failed)}:\n" + "\n".join(log))
        tmp_lib = work / out.name
        cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
               "-o", str(tmp_lib), *[str(o) for _, o, _, _ in procs]]
        r = subprocess.run(cmd, stdout=subprocess.PIPE,
                           stderr=subprocess.STDOUT, text=True)
        log.append(f"$ {' '.join(cmd)}\n{r.stdout}")
        if r.returncode != 0:
            raise KernelCompileError("link failed:\n" + "\n".join(log))
        os.replace(tmp_lib, out)      # atomic: a concurrent build is harmless
        return "\n".join(log)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def load_library() -> ctypes.CDLL:
    """The kernels' shared library, built on first call, with argtypes set.
    Safe from two threads: a caller during the build waits for it."""
    if _LIB is not None:
        return _LIB
    with _LOCK:
        return _LIB if _LIB is not None else _load()


def _load() -> ctypes.CDLL:
    global _LIB
    srcs = sources()
    if not srcs:
        raise KernelCompileError(f"no CUDA sources under {CSRC}")
    out = build_dir() / f"librepro_torch_kernels_{_digest(srcs)}.so"
    t0 = time.perf_counter()
    BuildInfo.cached = out.exists()
    if not BuildInfo.cached:
        out.parent.mkdir(parents=True, exist_ok=True)
        BuildInfo.log = _compile(srcs, out)
    lib = ctypes.CDLL(str(out))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    BuildInfo.path = out
    BuildInfo.seconds = time.perf_counter() - t0
    _LIB = lib
    return lib


@functools.lru_cache(maxsize=None)
def sm_count(device_index: int) -> int:
    """The SM count of a CUDA device (the kernels' plans read it)."""
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def check_launch(code: int, what: str) -> None:
    """Raise if a C launch function returned a CUDA error code."""
    if code != 0:
        raise RuntimeError(
            f"{what}: kernel launch failed with CUDA error {code} "
            f"(cudaGetLastError)")
