#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port: ``python3 chip_smoke.py``.

Needs one CUDA device (built and measured for an NVIDIA H100, sm_90a) and
``nvcc``; exits non-zero without them.  Imports ``repro_torch`` only.

Phases, one JSON line each:

1. ``device``        card name and power limit (``nvidia-smi``), versions;
2. ``build``         nvcc build of the kernels' library, ptxas resources;
3. ``kernels``       every CUDA kernel against its plain PyTorch version on
                     the card (small shapes incl. window masking, unmapped
                     pages, scatter leaving other rows alone, gather∘scatter
                     round trip; and the serving path's shapes), with times;
4. ``decode_parity`` one full-width ``decode_step`` (2 layers), kernel path
                     against plain path;
5. ``spill_parity``  the serve scenario at 2 layers: an undersized KV pool
                     (spills, fault-back-ins) generates the same tokens as
                     an exact-fit pool;
6. ``serve``         ``ServingEngine`` on full-width, full-depth Qwen3-14B
                     with random weights, greedy, undersized KV pool; launch
                     counters are zeroed just before and read just after;
7. ``profile``       only with ``--profile``: one batch-1 decode step under
                     ``torch.profiler``, host time against device time.

Then one ``{"kernels": [...]}`` line (per kernel: launches on the serve
path, error, time, plain / library time, roofline bound), the
``nvidia-smi`` line, and last ``{"ok": true, "device": {...}}``.
Any failing phase raises: the run exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}   # dense, by input type

TOL = {"float32": 2e-5, "bfloat16": 2e-2}     # atol = rtol, as the CPU tests


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


# --------------------------------------------------------------------- sizes
@dataclasses.dataclass
class Sizes:
    """Shapes of the run; the defaults are the serving path's on Qwen3-14B."""
    arch: str = "qwen3_14b"
    full_width: bool = True
    serve_layers: int = 0            # 0 = the config's own depth
    parity_layers: int = 2
    max_batch: int = 4
    pages_per_seq: int = 4
    pool_frames: int = 5
    prompts: tuple = (320, 80, 576, 288, 144, 432)
    max_new: int = 8
    timing_iters: int = 50
    timing_layers: int = 8           # distinct pools cycled through: L2-cold


# ------------------------------------------------------------------- helpers
def sync(dev) -> None:
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def time_ms(dev, fns, iters: int) -> float:
    """Mean device ms per call over ``iters`` calls cycling through ``fns``
    (each on its own buffers, so a call finds the L2 cold as the model
    does): the summed time of the kernels a call runs, read from
    ``torch.profiler``.  A wrapper's host side can take longer than its
    kernel, so the time between two CUDA events would then measure the
    host; that time is the fallback when the profiler reports no kernels."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for f in fns:
        f()
    sync(dev)
    if dev.type != "cuda":
        t0 = time.perf_counter()
        for i in range(iters):
            fns[i % len(fns)]()
        return (time.perf_counter() - t0) * 1e3 / iters
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fns[i % len(fns)]()
    stop.record()
    torch.cuda.synchronize(dev)
    events_ms = start.elapsed_time(stop) / iters
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) \
            as prof:
        for i in range(iters):
            fns[i % len(fns)]()
        torch.cuda.synchronize(dev)
    kernel_us = sum(e.self_device_time_total for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA)
    EVENTS_MS.append(events_ms)
    return kernel_us / 1e3 / iters if kernel_us > 0 else events_ms


EVENTS_MS: list = []     # the CUDA-event time of every time_ms call, in order


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def check_close(a, b, tol: float, what: str) -> float:
    import torch
    require(a.shape == b.shape and a.dtype == b.dtype, f"{what}: shape/dtype")
    require(bool(torch.isfinite(a.float()).all()), f"{what}: not finite")
    err = max_err(a, b)
    ok = bool(((a.float() - b.float()).abs()
               <= tol + tol * b.float().abs()).all())
    require(ok, f"{what}: max abs err {err} beyond atol=rtol={tol}")
    return err


# -------------------------------------------------------------- phase: device
def phase_device(dev):
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    emit("device", nvidia_smi=smi, kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, python=sys.version.split()[0])
    return smi


# --------------------------------------------------------------- phase: build
def phase_build():
    from repro_torch.kernels import _build
    _build.load_library()
    info = _build.BuildInfo
    res = [ln.strip() for ln in info.log.splitlines()
           if "registers" in ln or "Compiling entry" in ln
           or "spill" in ln]
    emit("build", seconds=round(info.seconds, 3), cached=info.cached,
         library=os.path.basename(str(info.path)),
         sources=[s.name for s in _build.sources()], ptxas=res)


# ------------------------------------------------------------- phase: kernels
def _rand(gen, shape, dtype, dev):
    import torch
    return torch.randn(shape, generator=gen, device=dev,
                       dtype=torch.float32).to(dtype)


def _attn_case(gen, dev, B, H, KVH, D, ps, NP, dtype, lengths=None,
               window=0):
    import torch
    from repro_torch.kernels.paged_attention.ops import paged_attention
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref
    P = B * NP
    q = _rand(gen, (B, H, D), dtype, dev)
    kp = _rand(gen, (P, ps, KVH, D), dtype, dev)
    vp = _rand(gen, (P, ps, KVH, D), dtype, dev)
    if lengths is None:
        lengths = [max(1, round(1 + i * (NP * ps - 1) / max(1, B - 1)))
                   for i in range(B)]
    pt = torch.arange(P, dtype=torch.int32, device=dev).reshape(B, NP)
    ln = torch.as_tensor(lengths, dtype=torch.int32).to(dev)
    out = paged_attention(q, kp, vp, pt, ln, window=window)
    sync(dev)
    ref = paged_attention_ref(q, kp, vp, pt, ln, window=window)
    name = str(dtype).split(".")[-1]
    return check_close(out, ref, TOL[name],
                       f"paged_attention B{B} H{H} KVH{KVH} D{D} ps{ps} "
                       f"NP{NP} {name} window={window}")


def phase_kernels(dev, sz: Sizes, cfg):
    import torch
    from repro_torch.kernels.page_pack.ops import gather_pages, scatter_pages
    from repro_torch.kernels.page_pack.ref import (page_gather_ref,
                                                   page_scatter_ref)
    from repro_torch.kernels.paged_attention.ops import paged_attention
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    f32, bf16 = torch.float32, torch.bfloat16
    errs = {"paged_attention": 0.0, "page_gather": 0.0, "page_scatter": 0.0}
    n_cases = 0

    # ---- kernel 1, small shapes (the CPU tests' cases) --------------------
    for (B, H, KVH, D, ps, NP) in [(1, 4, 4, 16, 4, 2), (2, 8, 2, 32, 8, 3),
                                   (3, 8, 1, 64, 8, 4), (2, 16, 8, 128, 16, 2),
                                   (2, 10, 2, 32, 8, 3), (2, 24, 2, 64, 8, 5)]:
        for dt in (f32, bf16):
            e = _attn_case(gen, dev, B, H, KVH, D, ps, NP, dt)
            errs["paged_attention"] = max(errs["paged_attention"], e)
            n_cases += 1
    for w in (8, 16):                                   # window masking
        e = _attn_case(gen, dev, 2, 8, 2, 32, 8, 4, f32, lengths=[32, 16],
                       window=w)
        errs["paged_attention"] = max(errs["paged_attention"], e)
        n_cases += 1
    # unmapped pages: -1 entries contribute nothing
    q = _rand(gen, (1, 4, 16), f32, dev)
    kp = _rand(gen, (4, 4, 4, 16), f32, dev)
    vp = _rand(gen, (4, 4, 4, 16), f32, dev)
    ln = torch.tensor([8], dtype=torch.int32, device=dev)
    a = paged_attention(q, kp, vp, torch.tensor(
        [[0, 1, -1, -1]], dtype=torch.int32, device=dev), ln)
    b = paged_attention(q, kp, vp, torch.tensor(
        [[0, 1, 2, 3]], dtype=torch.int32, device=dev), ln)
    sync(dev)
    check_close(a, b, 1e-6, "paged_attention unmapped pages")
    ln16 = torch.tensor([16], dtype=torch.int32, device=dev)
    hole = torch.tensor([[0, -1, 2, 3]], dtype=torch.int32, device=dev)
    e = check_close(paged_attention(q, kp, vp, hole, ln16),
                    paged_attention_ref(q, kp, vp, hole, ln16), TOL["float32"],
                    "paged_attention unmapped page inside the context")
    errs["paged_attention"] = max(errs["paged_attention"], e)
    n_cases += 2

    # ---- kernel 1, the serving path's shapes ------------------------------
    H, KVH, D, ps = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, \
        cfg.kv_page_tokens
    B, NP = sz.max_batch, sz.pages_per_seq
    ragged = [max(1, int(ps * NP * f)) for f in
              (0.2, 0.3, 0.6, 1.0, 0.45, 0.8, 0.1, 0.7)][:B]
    main_err = 0.0
    for dt in (bf16, f32):
        e = _attn_case(gen, dev, B, H, KVH, D, ps, NP, dt, lengths=ragged)
        e1 = _attn_case(gen, dev, 1, H, KVH, D, ps, NP, dt, lengths=[1])
        e2 = _attn_case(gen, dev, B, H, KVH, D, ps, NP, dt,
                        lengths=[1] * B)              # idle slots: length 1
        if dt == bf16:
            main_err = max(e, e1, e2)
        errs["paged_attention"] = max(errs["paged_attention"], e, e1, e2)
        n_cases += 3

    # timing: a stacked pool of several layers, one layer per call
    Lt = sz.timing_layers
    P = B * NP
    kpool = _rand(gen, (Lt, P, ps, KVH, D), bf16, dev)
    vpool = _rand(gen, (Lt, P, ps, KVH, D), bf16, dev)
    q = _rand(gen, (B, H, D), bf16, dev)
    pt = torch.arange(P, dtype=torch.int32, device=dev).reshape(B, NP)
    ln = torch.tensor(ragged, dtype=torch.int32, device=dev)
    it = sz.timing_iters
    attn_ms = time_ms(dev, [lambda l=l: paged_attention(
        q, kpool[l], vpool[l], pt, ln) for l in range(Lt)], it)
    attn_plain_ms = time_ms(dev, [lambda l=l: paged_attention_ref(
        q, kpool[l], vpool[l], pt, ln) for l in range(Lt)], max(4, it // 5))
    rows = int(sum(ragged))
    attn_bytes = (2 * rows * KVH * D + 2 * B * H * D) * 2 + pt.numel() * 4 \
        + ln.numel() * 4
    attn_flops = 4 * rows * H * D                 # q.k and p.v multiply-adds
    attn_ops_s = attn_flops / PEAK_FLOPS["bfloat16"]
    attn_bound = max(attn_bytes / HBM_BYTES_PER_S, attn_ops_s)
    q1 = q[:1].contiguous()
    pt1 = pt[:1].contiguous()
    ln1 = ln[3 % B:3 % B + 1].contiguous()
    attn_b1_ms = time_ms(dev, [lambda l=l: paged_attention(
        q1, kpool[l], vpool[l], pt1, ln1) for l in range(Lt)], it)
    # yardstick only, not the same inputs: SDPA on K/V gathered beforehand
    S = NP * ps
    kg = kpool[0][pt.long()].reshape(B, S, KVH, D).transpose(1, 2)
    vg = vpool[0][pt.long()].reshape(B, S, KVH, D).transpose(1, 2)
    qg = q.reshape(B, KVH, H // KVH, D)
    mask = (torch.arange(S, device=dev)[None, :] < ln[:, None])[:, None,
                                                               None, :]
    sdpa_ms = time_ms(dev, [lambda: torch.nn.functional
                            .scaled_dot_product_attention(
                                qg, kg, vg, attn_mask=mask)], it)
    del kpool, vpool, kg, vg

    # ---- kernels 2 and 3, small shapes -----------------------------------
    for (Pn, n, E) in [(8, 4, 32), (64, 16, 128), (16, 16, 64), (8, 5, 7),
                       (8, 5, 3)]:
        for dt in (f32, bf16, torch.int32):
            if dt == torch.int32:
                pool = torch.randint(0, 100, (Pn, E), generator=gen,
                                     device=dev, dtype=dt)
            else:
                pool = _rand(gen, (Pn, E), dt, dev)
            idx = torch.randperm(Pn, generator=gen, device=dev)[:n] \
                .to(torch.int32)
            idx[0] = -1
            got = gather_pages(pool, idx)
            sync(dev)
            require(torch.equal(got, page_gather_ref(pool, idx)),
                    f"page_gather P{Pn} n{n} E{E} {dt}")
            blk = got.flip(0).contiguous()
            want = page_scatter_ref(pool.clone(), idx[1:], blk[1:])
            out = scatter_pages(pool.clone(), idx[1:], blk[1:].contiguous())
            sync(dev)
            require(torch.equal(out, want),
                    f"page_scatter P{Pn} n{n} E{E} {dt}")
            n_cases += 2
    pool = _rand(gen, (16, 32), f32, dev)
    before = pool.clone()
    idx = torch.tensor([2, 9, 14], dtype=torch.int32, device=dev)
    blk = _rand(gen, (3, 32), f32, dev)
    scatter_pages(pool, idx, blk)
    sync(dev)
    keep = [r for r in range(16) if r not in (2, 9, 14)]
    require(torch.equal(pool[keep], before[keep])
            and torch.equal(pool[idx.long()], blk),
            "page_scatter touched rows it was not given")
    pool = _rand(gen, (32, 8, 16), f32, dev)
    idx = torch.tensor([5, 1, 30, 7], dtype=torch.int32, device=dev)
    pages = gather_pages(pool, idx)
    pool2 = scatter_pages(torch.zeros_like(pool), idx, pages)
    sync(dev)
    want = torch.zeros_like(pool)
    want[idx.long()] = pool[idx.long()]
    require(torch.equal(pool2, want), "gather∘scatter round trip")
    n_cases += 2

    # ---- kernels 2 and 3, the serving path's shape ------------------------
    # one sequence's pages of every layer <-> its batch slot: rows of
    # E = ps·KVH·D elements in the decode cache viewed as (L·P, E)
    E = ps * KVH * D
    L = sz.serve_layers or cfg.n_layers
    per_seq = NP
    pool = _rand(gen, (L * P, E), bf16, dev)
    slot = min(2, B - 1)
    idx = (torch.arange(L, dtype=torch.int32)[:, None] * P + slot * per_seq
           + torch.arange(per_seq, dtype=torch.int32)[None, :]) \
        .reshape(-1).to(dev)
    n = idx.numel()
    blocks = [_rand(gen, (n, E), bf16, dev) for _ in range(2)]
    got = gather_pages(pool, idx, out=blocks[0])
    sync(dev)
    require(torch.equal(got, page_gather_ref(pool, idx)),
            "page_gather serving shape")
    want = page_scatter_ref(pool.clone(), idx, blocks[1])
    out = scatter_pages(pool.clone(), idx, blocks[1])
    sync(dev)
    require(torch.equal(out, want), "page_scatter serving shape")
    del want, out
    n_cases += 2
    idx_l = idx.long()
    copy_it = max(4, it // 2)
    gather_ms = time_ms(dev, [lambda b=b: gather_pages(pool, idx, out=b)
                              for b in blocks], copy_it)
    gather_plain = time_ms(dev, [lambda b=b: page_gather_ref(pool, idx, out=b)
                                 for b in blocks], copy_it)
    gather_lib = time_ms(dev, [lambda b=b: torch.index_select(
        pool, 0, idx_l, out=b) for b in blocks], copy_it)
    scatter_ms = time_ms(dev, [lambda b=b: scatter_pages(pool, idx, b)
                               for b in blocks], copy_it)
    scatter_plain = time_ms(dev, [lambda b=b: page_scatter_ref(pool, idx, b)
                                  for b in blocks], copy_it)
    scatter_lib = time_ms(dev, [lambda b=b: pool.index_copy_(0, idx_l, b)
                                for b in blocks], copy_it)
    copy_bytes = 2 * n * E * pool.element_size() + n * 4
    copy_bound = copy_bytes / HBM_BYTES_PER_S
    del pool, blocks

    src = "src/repro_torch/kernels/csrc/"
    ref = "src/repro/kernels/"
    table = [
        {"name": "paged_attention", "route": "cuda",
         "source": src + "paged_attention.cu",
         "replaces": ref + "paged_attention/paged_attention.py:81",
         "launches": 0, "max_abs_err": main_err, "ms": attn_ms,
         "plain_ms": attn_plain_ms, "bound_ms": attn_bound * 1e3,
         "bound_by": "bytes" if attn_bytes / HBM_BYTES_PER_S >= attn_ops_s
         else "operations",
         "library_ms": None, "sdpa_on_pregathered_kv_ms": sdpa_ms,
         "batch1_ms": attn_b1_ms, "bytes": attn_bytes,
         "shape": {"B": B, "H": H, "KVH": KVH, "D": D, "ps": ps, "NP": NP,
                   "lengths": ragged, "dtype": "bfloat16"}},
        {"name": "page_gather", "route": "cuda", "source": src + "page_pack.cu",
         "replaces": ref + "page_pack/page_pack.py:25", "launches": 0,
         "max_abs_err": 0.0, "ms": gather_ms, "plain_ms": gather_plain,
         "bound_ms": copy_bound * 1e3, "bound_by": "bytes",
         "library_ms": gather_lib, "library": "torch.index_select",
         "bytes": copy_bytes,
         "shape": {"pool": [L * P, E], "n": n, "dtype": "bfloat16"}},
        {"name": "page_scatter", "route": "cuda",
         "source": src + "page_pack.cu",
         "replaces": ref + "page_pack/page_pack.py:53", "launches": 0,
         "max_abs_err": 0.0, "ms": scatter_ms, "plain_ms": scatter_plain,
         "bound_ms": copy_bound * 1e3, "bound_by": "bytes",
         "library_ms": scatter_lib, "library": "Tensor.index_copy_",
         "bytes": copy_bytes,
         "shape": {"pool": [L * P, E], "n": n, "dtype": "bfloat16"}},
    ]
    names = ("paged_attention", "paged_attention_plain",
             "paged_attention_batch1", "sdpa_on_pregathered_kv", "page_gather",
             "page_gather_plain", "index_select", "page_scatter",
             "page_scatter_plain", "index_copy_")
    emit("kernels", cases=n_cases, max_abs_err_all_cases=errs,
         timing="device time of the call's kernels (torch.profiler)",
         cuda_event_ms_per_call=dict(zip(names, EVENTS_MS)),
         tolerance={"float32": TOL["float32"], "bfloat16": TOL["bfloat16"],
                    "copies": "exact"}, kernels=table)
    return table


# ------------------------------------------------------- phase: decode parity
def phase_decode_parity(dev, sz: Sizes, cfg):
    """One decode step over a warm ragged cache, kernel path vs plain path.

    bf16 logits, atol = rtol = 5e-2: the two attention outputs differ by one
    bf16 rounding (2^-8 relative) and that difference passes through two
    layers and the vocabulary projection."""
    import torch
    from repro_torch.kernels import launch_counts
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import decoder

    pcfg = dataclasses.replace(cfg, n_layers=sz.parity_layers)
    params = decoder.init_params(pcfg, 1, device=dev)
    B, ps = sz.max_batch, pcfg.kv_page_tokens
    max_len = sz.pages_per_seq * ps
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    base = decoder.init_decode_cache(pcfg, B, max_len, device=dev)
    for name in ("k_pool", "v_pool"):
        base[name].copy_(_rand(gen, base[name].shape, base[name].dtype, dev))
    fracs = (0.3, 0.05, 0.55, 0.97, 0.4, 0.7, 0.2, 0.8)
    base["lengths"] = torch.tensor(
        [max(1, int(max_len * f)) - 1 for f in fracs[:B]], dtype=torch.int32,
        device=dev)
    tokens = torch.randint(0, pcfg.vocab_size, (B, 1), generator=gen,
                           device=dev)

    def clone(c):
        return {k: v.clone() for k, v in c.items()}

    before = launch_counts()["paged_attention"]
    logits_k, cache_k = decoder.decode_step(params, pcfg, clone(base), tokens)
    sync(dev)
    launched = launch_counts()["paged_attention"] - before
    if dev.type == "cuda":
        require(launched == pcfg.n_layers,
                f"decode_step launched the kernel {launched} times, expected "
                f"{pcfg.n_layers}")
    kernel_fn = attn_mod.paged_attention
    attn_mod.paged_attention = paged_attention_ref      # plain path, on card
    try:
        logits_p, cache_p = decoder.decode_step(params, pcfg, clone(base),
                                                tokens)
    finally:
        attn_mod.paged_attention = kernel_fn
    sync(dev)
    require(tuple(logits_k.shape) == (B, 1, pcfg.vocab_size), "logits shape")
    err = check_close(logits_k, logits_p, 5e-2, "decode_step logits")
    # layer 0 writes its K/V before any attention ran: identical; deeper
    # layers see the attention outputs, which differ by bf16 roundings
    require(torch.equal(cache_k["k_pool"][0], cache_p["k_pool"][0])
            and torch.equal(cache_k["lengths"], cache_p["lengths"]),
            "decode_step cache update differs between the two paths")
    check_close(cache_k["v_pool"], cache_p["v_pool"], 5e-2,
                "decode_step V pools")
    agree = float((logits_k.argmax(-1) == logits_p.argmax(-1)).float().mean())
    emit("decode_parity", layers=pcfg.n_layers, d_model=pcfg.d_model,
         vocab=pcfg.vocab_size, batch=B,
         lengths=[int(x) + 1 for x in base["lengths"].tolist()],
         max_abs_err=err, tolerance=5e-2, logits_abs_max=float(
             logits_p.float().abs().max()), argmax_agree=agree,
         kernel_launches=launched)
    return params, pcfg


# --------------------------------------------------------------- serve phases
def _prompts(sz: Sizes, vocab: int):
    import numpy as np
    rng = np.random.default_rng(0)
    return [rng.integers(0, vocab, size=n) for n in sz.prompts]


def _serve(dev, sz: Sizes, cfg, params, pool_frames):
    from repro_torch.api import FaultPolicy, Strategy
    from repro_torch.serving.engine import ServingEngine
    eng = ServingEngine(
        cfg, params, max_batch=sz.max_batch,
        max_len=sz.pages_per_seq * cfg.kv_page_tokens,
        pool_frames=pool_frames,
        policy=FaultPolicy(strategy=Strategy.TOUCH_AHEAD, lookahead=4),
        device=dev)
    reqs = [eng.submit(p, max_new_tokens=sz.max_new)
            for p in _prompts(sz, cfg.vocab_size)]
    sync(dev)
    t0 = time.perf_counter()
    eng.run_until_done()
    sync(dev)
    return eng, reqs, time.perf_counter() - t0


def phase_spill_parity(dev, sz: Sizes, pcfg, params):
    eng_a, reqs_a, _ = _serve(dev, sz, pcfg, params, None)
    eng_b, reqs_b, _ = _serve(dev, sz, pcfg, params, sz.pool_frames)
    require(eng_a.stats.spill_events == 0, "exact-fit pool spilled")
    require(eng_b.stats.spill_events > 0 and eng_b.stats.fault_page_ins > 0,
            "undersized pool did not spill")
    same = [a.generated == b.generated for a, b in zip(reqs_a, reqs_b)]
    require(all(same) and all(r.done for r in reqs_b),
            f"tokens differ between exact-fit and undersized pool: {same}")
    emit("spill_parity", layers=pcfg.n_layers, requests=len(reqs_b),
         tokens_identical=True, spill_events=eng_b.stats.spill_events,
         fault_page_ins=eng_b.stats.fault_page_ins)


def phase_serve(dev, sz: Sizes, cfg, table):
    import torch
    from repro_torch import kernels
    from repro_torch.models import decoder

    if sz.serve_layers:
        cfg = dataclasses.replace(cfg, n_layers=sz.serve_layers)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = decoder.init_params(cfg, 0, device=dev)
    sync(dev)
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in decoder._tree_leaves(params))

    kernels.reset_launch_counts()
    eng, reqs, wall = _serve(dev, sz, cfg, params, sz.pool_frames)
    counts = kernels.launch_counts()

    st = eng.stats
    prompt_tokens = sum(len(r.prompt) for r in reqs)
    step_calls = prompt_tokens + st.decode_steps    # decode_step invocations
    require(all(r.done and len(r.generated) == sz.max_new for r in reqs),
            "a request did not finish")
    require(all(0 <= t < cfg.vocab_size for r in reqs for t in r.generated),
            "token id out of range")
    require(st.tokens_generated == len(reqs) * sz.max_new, "token count")
    require(st.spill_events > 0 and st.fault_page_ins > 0,
            f"no spill / fault-back-in: {st}")
    if dev.type == "cuda":
        require(counts["paged_attention"] == cfg.n_layers * step_calls,
                f"paged_attention launches {counts['paged_attention']} != "
                f"{cfg.n_layers} layers x {step_calls} decode_step calls")
        require(counts["page_gather"] > 0 and counts["page_scatter"] > 0
                and counts["page_gather"] == counts["page_scatter"],
                f"page gather/scatter launches: {counts}")
    for row in table:
        row["launches"] = counts[row["name"]]
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    emit("serve", arch=cfg.name, layers=cfg.n_layers, d_model=cfg.d_model,
         params=n_params, dtype=cfg.dtype, init_seconds=round(init_s, 3),
         max_batch=sz.max_batch, max_len=sz.pages_per_seq * cfg.kv_page_tokens,
         page_tokens=cfg.kv_page_tokens, pool_frames=sz.pool_frames,
         requests_done=sum(r.done for r in reqs),
         prompt_lengths=[len(r.prompt) for r in reqs],
         tokens_generated=st.tokens_generated, decode_steps=st.decode_steps,
         decode_step_calls=step_calls, wall_seconds=wall,
         generated_tokens_per_s=st.tokens_generated / wall,
         processed_tokens_per_s=(prompt_tokens + st.tokens_generated) / wall,
         engine_stats=dataclasses.asdict(st),
         kv_stats={k: v for k, v in dataclasses.asdict(eng.kv.stats).items()
                   if v},
         max_memory_allocated=peak, launches=counts,
         first_tokens=[r.generated[:4] for r in reqs])
    return params, cfg


# ------------------------------------------------------------ phase: profile
def phase_profile(dev, sz: Sizes, cfg, params, steps: int = 4):
    """Optional (``--profile``): where one batch-1 decode step spends its
    time — host wall clock against summed device time, kernels by name."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import decoder

    max_len = sz.pages_per_seq * cfg.kv_page_tokens
    cache = decoder.init_decode_cache(cfg, 1, max_len, device=dev)
    cache["lengths"] += max_len // 3
    tok = torch.zeros((1, 1), dtype=torch.int64, device=dev)
    for _ in range(2):
        _, cache = decoder.decode_step(params, cfg, cache, tok)
    sync(dev)
    t0 = time.perf_counter()
    for _ in range(steps):
        _, cache = decoder.decode_step(params, cfg, cache, tok)
    sync(dev)
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        for _ in range(steps):
            _, cache = decoder.decode_step(params, cfg, cache, tok)
        sync(dev)
    from torch.autograd import DeviceType
    rows = []                     # device kernels only, not the ops above them
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total", 0) or 0
        if dev_us > 0 and e.device_type == DeviceType.CUDA:
            rows.append((dev_us, e.count, e.key))
    rows.sort(reverse=True)
    total_us = sum(r[0] for r in rows)
    host = sorted(((e.self_cpu_time_total, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type != DeviceType.CUDA), reverse=True)
    emit("profile", layers=cfg.n_layers, batch=1,
         context=int(cache["lengths"][0]), steps=steps,
         wall_ms_per_step=wall_ms,
         device_ms_per_step=(total_us / 1e3 / steps) if rows
         else "not measured",
         device_busy_share=(total_us / 1e3 / steps / wall_ms) if rows
         else "not measured",
         device_launches_per_step=sum(r[1] for r in rows) / steps,
         top=[{"name": k[:80], "ms_per_step": us / 1e3 / steps,
               "calls_per_step": n / steps} for us, n, k in rows[:12]],
         host_ms_per_step_under_profiler=sum(h[0] for h in host) / 1e3 / steps,
         host_top=[{"name": k[:60], "self_ms_per_step": us / 1e3 / steps,
                    "calls_per_step": n / steps} for us, n, k in host[:14]])


# ----------------------------------------------------------------------- main
def run(dev, sz: Sizes, stop_after: str = "", with_profile: bool = False):
    """All phases after ``device``; returns the kernel table, or None when
    ``stop_after`` names an earlier phase (a partial run while debugging)."""
    from repro_torch.configs import get_config
    from repro_torch.models.config import reduced

    cfg = get_config(sz.arch)
    if not sz.full_width:
        cfg = reduced(cfg)
    phase_build()
    if stop_after == "profile":            # the profile alone, full depth
        from repro_torch.models import decoder
        phase_profile(dev, sz, cfg, decoder.init_params(cfg, 0, device=dev),
                      steps=8)
        return None
    table = phase_kernels(dev, sz, cfg)
    if stop_after == "kernels":
        return None
    params, pcfg = phase_decode_parity(dev, sz, cfg)
    phase_spill_parity(dev, sz, pcfg, params)
    del params
    if stop_after == "spill_parity":
        return None
    params, scfg = phase_serve(dev, sz, cfg, table)
    if with_profile:
        phase_profile(dev, sz, scfg, params, steps=8)
    return table


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); this run needs a GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "src"))
    dev = torch.device("cuda", 0)
    smi = phase_device(dev)
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--stop-after", default="",
                    choices=["", "profile", "kernels", "spill_parity"],
                    help="partial run for debugging; prints no result line")
    ap.add_argument("--profile", action="store_true",
                    help="after serve, profile a batch-1 decode step")
    args = ap.parse_args()
    table = run(dev, Sizes(), args.stop_after, args.profile)
    if table is None:
        return 0
    for row in table:
        for key in ("max_abs_err", "ms", "plain_ms", "bound_ms"):
            require(math.isfinite(row[key]), f"{row['name']}: {key}")
        require(row["launches"] > 0, f"{row['name']} never launched on the "
                "serving path")
    print(json.dumps({"kernels": table}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
