"""Multi-pod dry-run, traced rather than compiled.

The reference lowers and compiles each (arch, shape, mesh) cell with XLA
on 512 placeholder host devices and reads the compiled HLO.  The port has
no compiler to ask: a cell sets up a **fake process group** of 256 or 512
ranks (this process is rank 0; collectives move nothing), builds the
production mesh over it, makes every input a DTensor of **fake** local
shards (``FakeTensorMode``: shapes and dtypes, no storage) with the
reference's shardings, and runs the step once under the arch's logical
rules while ``analysis.trace`` counts one rank's FLOPs, collective bytes
and HBM-bytes estimate and ``MemTracker`` its peak memory.

The fake tensors are CPU tensors, so the model takes the kernels' plain
versions (``"traced_path": "plain"``), as the reference's dry-run lowers
its model path's ``lax.scan`` fallbacks.  ``lower_s`` and ``compile_s``
are the trace's time.  The roofline terms use the H100 data-sheet values
of ``launch.mesh``.

    python -m repro_torch.launch.dryrun --arch codeqwen15_7b --mesh multi
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback

import numpy as np
import torch
from torch.distributed._tools.mem_tracker import MemTracker

from repro_torch.analysis.trace import _METADATA, counting
from repro_torch.compat import cost_analysis_dict
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.shapes import SHAPES, shapes_for, skip_reason
from repro_torch.distributed.logical import (PartitionSpec as P,
                                             logical_rules, mesh_shape)
from repro_torch.distributed.sharding import (NamedSharding, cache_shardings,
                                              opt_state_shardings,
                                              param_shardings,
                                              token_sharding)
from repro_torch.launch.mesh import (HBM_PER_CHIP, HBM_BW, ICI_BW_PER_LINK,
                                     PEAK_FLOPS_BF16, make_production_mesh)
from repro_torch.launch.specs import input_specs, params_specs
from repro_torch.models.registry import model_for
from repro_torch.optim import adamw
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.training.trainer import TrainConfig, make_train_step

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "results", "dryrun_torch")

# Per-arch training knobs (the reference's): microbatch counts keep
# layer-boundary residuals under HBM.
MICROBATCHES = {
    "chameleon_34b": 16, "codeqwen15_7b": 4, "qwen3_14b": 2,
    "starcoder2_3b": 2, "h2o_danube_1_8b": 4, "mixtral_8x7b": 4,
    "deepseek_v3_671b": 16, "zamba2_7b": 4, "xlstm_125m": 1,
    "whisper_medium": 8,
}
# FSDP/ZeRO-3 param+moment sharding for the larger archs
ZERO3 = {"chameleon_34b", "codeqwen15_7b", "qwen3_14b", "mixtral_8x7b",
         "deepseek_v3_671b", "zamba2_7b"}
# bf16 moments for the biggest (MaxText convention)
BF16_MOMENTS = {"deepseek_v3_671b", "chameleon_34b"}


def _train_config(arch: str) -> TrainConfig:
    return TrainConfig(
        microbatches=MICROBATCHES.get(arch, 1),
        remat=True,
        optimizer=AdamWConfig(
            moment_dtype="bfloat16" if arch in BF16_MOMENTS else "float32"))


@contextlib.contextmanager
def fake_world(n_ranks: int):
    """A fake process group of ``n_ranks`` (this process rank 0) for the
    block, destroyed on the way out."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialized")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=n_ranks)
    try:
        yield
    finally:
        dist.destroy_process_group()


def logical_rules_for(cfg, mesh) -> dict:
    """Bind logical activation axes to mesh axes per arch (the reference's
    rules).

    heads→'model' when the head count divides TP; otherwise the query
    sequence is context-parallel over 'model' (starcoder2's 24 heads,
    qwen3's 40 heads).  KV stays replicated in that case (cheap: GQA).
    """
    sizes = mesh_shape(mesh)
    d = [a for a in ("pod", "data") if a in sizes]
    batch_ax = tuple(d) if len(d) > 1 else (d[0] if d else None)
    m = sizes["model"]
    rules = {"batch": batch_ax, "ff": "model", "moe_ff": "model"}
    data = sizes.get("data", 1)
    if cfg.n_experts and cfg.n_experts % (m * data) == 0:
        rules["experts"] = ("model", "data")   # matches 2-D EP weights
    elif cfg.n_experts and cfg.n_experts % m == 0:
        rules["experts"] = "model"
    if cfg.n_heads % m == 0:
        rules["heads"] = "model"
        if cfg.n_kv_heads % m == 0:
            rules["kv_heads"] = "model"
    else:
        rules["q_seq"] = "model"
    return rules


def build_lowerable(arch: str, shape_name: str, mesh):
    """Returns (fn, arg_specs, in_shardings, out_shardings,
    donate_argnums): the step, its inputs as ``meta`` tensors and their
    shardings.  The port updates parameters, optimizer state and caches in
    place, so ``out_shardings`` and ``donate_argnums`` only name what the
    reference's jit would alias."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    model = model_for(cfg)
    bundle = input_specs(cfg, shape)
    p_specs = params_specs(cfg)
    p_sh = param_shardings(p_specs, mesh, zero3=arch in ZERO3)
    sizes = mesh_shape(mesh)
    dsize = int(np.prod([sizes[a] for a in ("pod", "data") if a in sizes]))
    batch_shardable = shape.global_batch % dsize == 0
    tok_sh = token_sharding(mesh, shardable_batch=batch_shardable)
    frame_sh = NamedSharding(mesh, P(tok_sh.spec[0], None, None))

    if shape.kind == "train":
        tcfg = _train_config(arch)
        # per-microbatch batch must still divide the data axes
        m = tcfg.microbatches
        while m > 1 and (shape.global_batch // m) % max(1, dsize) != 0:
            m //= 2
        if m != tcfg.microbatches:
            tcfg = dataclasses.replace(tcfg, microbatches=m)
        step = make_train_step(cfg, tcfg)
        opt_specs = adamw.init(tcfg.optimizer, p_specs)
        opt_sh = opt_state_shardings(opt_specs, p_sh, mesh)
        args = (p_specs, opt_specs) + bundle.args
        in_sh = (p_sh, opt_sh) + (tok_sh,) * 2
        if cfg.is_encdec:
            in_sh = in_sh + (frame_sh,)
        return step, args, in_sh, (p_sh, opt_sh, None), (0, 1)

    if shape.kind == "prefill":
        def fn(params, tokens, *extra):
            kw = {}
            if cfg.is_encdec:
                kw["frame_embeddings"] = extra[0]
            with torch.no_grad():
                logits, _ = model.forward(params, cfg, tokens, **kw)
            return logits
        args = (p_specs,) + bundle.args
        in_sh = (p_sh, tok_sh)
        if cfg.is_encdec:
            in_sh = in_sh + (frame_sh,)
        return fn, args, in_sh, None, ()

    # decode
    def fn(params, cache, tokens):
        return model.decode_step(params, cfg, cache, tokens)
    c_sh = cache_shardings(bundle.cache, mesh, shape.global_batch)
    args = (p_specs, bundle.cache) + bundle.args
    return fn, args, (p_sh, c_sh, tok_sh), (None, c_sh), (1,)


def _placed(spec, sharding, locals_: list, fake_mode):
    """A fake DTensor per leaf of ``spec`` (``meta`` tensors), laid out by
    the matching leaf of ``sharding`` (NamedSharding), its local shard
    (made in ``fake_mode``) appended to ``locals_``.  The optimizer's 0-d
    step stays a plain tensor, as ``adamw.init`` makes it."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    if isinstance(spec, dict):
        return {k: _placed(spec[k], sharding[k], locals_, fake_mode)
                for k in spec}
    if isinstance(spec, tuple):
        parts = [_placed(s, sh, locals_, fake_mode)
                 for s, sh in zip(spec, sharding)]
        return type(spec)(*parts) if hasattr(spec, "_fields") \
            else tuple(parts)
    pl = sharding.placements
    shape = () if spec.ndim == 0 else compute_local_shape_and_global_offset(
        spec.shape, sharding.mesh, pl)[0]
    with fake_mode:
        local = torch.zeros(shape, dtype=spec.dtype)
        locals_.append(local)
        if spec.ndim == 0:
            return local
        return DTensor.from_local(local, sharding.mesh, pl, run_check=False,
                                  shape=spec.shape, stride=spec.stride())


class _LocalMemTracker(MemTracker):
    """``MemTracker`` under a ``TraceCounter`` (``counter``): it sees the
    local ops, and skips metadata reads and the ops of DTensor's sharding
    propagation (global shapes, made to learn an output's shape, never
    allocated on a device)."""

    counter = None

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in _METADATA or (self.counter is not None
                                 and self.counter.propagating):
            return func(*args, **(kwargs or {}))
        return super().__torch_dispatch__(func, types, args, kwargs)


def trace_cell(fn, args, in_sh, mesh, rules) -> tuple:
    """Run ``fn`` once over fake DTensors of ``args`` laid out by
    ``in_sh``, under ``rules``: (per-device ``HLOAnalysis``, peak memory
    by ``MemTracker`` category for this rank's device).

    The local shards are ``FakeTensor``s of a ``FakeTensorMode`` that is
    not entered around the step: ops on them stay fake, while DTensor's
    own index arithmetic (``torch.arange`` over a strided shard, read back
    with ``tolist``) runs on real CPU tensors, as it must; the model's
    own small real tensors (RoPE tables, iotas, accumulators) join the
    fake ones as constants."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    fake_mode = FakeTensorMode(allow_non_fake_inputs=True)
    locals_: list = []
    placed = _placed(tuple(args), tuple(in_sh), locals_, fake_mode)
    tracker = _LocalMemTracker()
    tracker.track_external(*locals_)
    with logical_rules(mesh, rules), tracker, counting() as counter:
        tracker.counter = counter
        fn(*placed)
    peak = tracker.get_tracker_snapshot("peak")
    mem = next(iter(peak.values())) if peak else {}
    return counter.analysis, {str(k): int(v) for k, v in mem.items()}


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             save: bool = True) -> dict:
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    reason = skip_reason(cfg, shape)
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    rec: dict = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                 "kind": shape.kind, "traced_path": "plain"}
    if reason:
        rec["status"] = "skip"
        rec["skip_reason"] = reason
        _save(rec, save)
        return rec
    n_dev = 512 if multi_pod else 256
    with fake_world(n_dev):
        mesh = make_production_mesh(multi_pod=multi_pod)
        # torch-lint: allow(det-wallclock): host trace timing, never sim state
        t0 = time.perf_counter()
        try:
            fn, args, in_sh, _, _ = build_lowerable(arch, shape_name, mesh)
            rules = logical_rules_for(cfg, mesh)
            rec["logical_rules"] = {k: str(v) for k, v in rules.items()}
            ana, mem = trace_cell(fn, args, in_sh, mesh, rules)
            # torch-lint: allow(det-wallclock): host trace timing
            t_trace = time.perf_counter() - t0
            ca = cost_analysis_dict(ana)
            per_dev_bytes = mem.get("Total", 0)
            tokens = shape.global_batch * (
                shape.seq_len if shape.kind != "decode" else 1)
            n_active = cfg.active_param_count()
            model_flops = (6 if shape.kind == "train" else 2) \
                * n_active * tokens

            flops_dev = ana.dot_flops
            terms = {"compute_s": flops_dev / PEAK_FLOPS_BF16,
                     "memory_s": ana.hbm_bytes / HBM_BW,
                     "collective_s": ana.collective_bytes / ICI_BW_PER_LINK}
            dominant = max(terms, key=terms.get)
            rec.update({
                "status": "ok",
                "n_devices": n_dev,
                "lower_s": round(t_trace, 2),
                "compile_s": round(t_trace, 2),
                "cost_analysis_flops": ca["flops"],
                "cost_analysis_bytes": ca["bytes accessed"],
                "hlo_dot_flops_per_dev": flops_dev,
                "hlo_hbm_bytes_per_dev": ana.hbm_bytes,
                "hlo_collective_bytes_per_dev": ana.collective_bytes,
                "collective_breakdown": ana.collective_breakdown,
                "memory_analysis": mem,
                "per_device_bytes": int(per_dev_bytes),
                "fits_hbm": bool(per_dev_bytes <= HBM_PER_CHIP),
                "model_flops_total": float(model_flops),
                "useful_flops_ratio": float(model_flops
                                            / max(1.0, flops_dev * n_dev)),
                "roofline_terms_s": terms,
                "dominant_term": dominant,
            })
        except Exception as e:      # a failed cell is a record, as in the reference
            rec["status"] = "error"
            rec["error"] = f"{type(e).__name__}: {e}"
            rec["traceback"] = traceback.format_exc()[-2000:]
    _save(rec, save)
    return rec


def _save(rec: dict, save: bool) -> None:
    if not save:
        return
    os.makedirs(RESULTS_DIR, exist_ok=True)
    name = f"{rec['arch']}__{rec['shape']}__{rec['mesh']}.json"
    with open(os.path.join(RESULTS_DIR, name), "w") as f:
        json.dump(rec, f, indent=1, default=str)


def main() -> None:
    ap = argparse.ArgumentParser(description="multi-pod dry-run (traced)")
    ap.add_argument("--arch", default=None, help="one arch id (default: all)")
    ap.add_argument("--shape", default=None, help="one shape (default: all)")
    ap.add_argument("--mesh", default="both",
                    choices=("single", "multi", "both"))
    ap.add_argument("--all", action="store_true")
    args = ap.parse_args()

    archs = [args.arch] if args.arch else list(ARCH_IDS)
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    failures = 0
    for arch in archs:
        cfg = get_config(arch)
        shapes = ([args.shape] if args.shape
                  else [s.name for s in shapes_for(cfg)]
                  + [s for s in SHAPES
                     if skip_reason(cfg, SHAPES[s])])
        for shape_name in shapes:
            for multi in meshes:
                rec = run_cell(arch, shape_name, multi)
                status = rec["status"]
                mesh_name = rec["mesh"]
                if status == "ok":
                    mem = rec["per_device_bytes"] / 2**30
                    print(f"[OK]   {arch:18s} {shape_name:12s} {mesh_name:10s}"
                          f" trace={rec['compile_s']:.1f}s"
                          f" mem/dev={mem:.2f}GiB fits={rec['fits_hbm']}"
                          f" dom={rec['dominant_term']}")
                elif status == "skip":
                    print(f"[SKIP] {arch:18s} {shape_name:12s} {mesh_name:10s}"
                          f" ({rec['skip_reason'][:60]})")
                else:
                    failures += 1
                    print(f"[FAIL] {arch:18s} {shape_name:12s} {mesh_name:10s}"
                          f" {rec['error'][:140]}")
    if failures:
        raise SystemExit(f"{failures} dry-run cells failed")


if __name__ == "__main__":
    main()
