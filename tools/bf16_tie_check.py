#!/usr/bin/env python3
"""Whether a bf16 greedy token that differs between the kernel path and
the plain path is a tie: ``python3 tools/bf16_tie_check.py [--arch A]
[--layers N ...]``.

For each depth, ``chip_smoke.py``'s serving scenario (its requests,
batch, context and undersized pool; random weights from seed 0, at that
depth) runs on one GPU four times through ``ServingEngine``, with the
arch's window off so decode goes through the paged pools:

* bf16, kernel path, every ``paged_attention`` call held against
  ``paged_attention_ref`` on its own inputs (``chip_smoke``'s bf16
  tolerance): ``calls``, ``beyond_tolerance``, ``max_abs_err``;
* bf16, plain path (``paged_attention_ref``);
* float32, kernel path, and float32, plain path.

Each batch decode step's logits are read as the engine computes them: per
batch row the top token, the top-2 gap and max|logit|.  Printed per depth:
whether each request's bf16 tokens and f32 tokens are equal kernel vs
plain, and at the first batch step where a row's bf16 top token differs,
both paths' gaps (a gap of one bf16 ulp at the logits' magnitude is a
tie, which either rounding may break either way).

One JSON line per depth, then the card's name and power limit.  Builds
the kernels into ``build/`` at first use; needs ``nvcc``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class _Recorder:
    """The decoder module with ``decode_step`` recording, for each batch
    step (more than one row), every row's top token, top-2 gap and
    max|logit|."""

    def __init__(self, model, steps: list):
        self._model, self.steps = model, steps

    def __getattr__(self, name):
        return getattr(self._model, name)

    def decode_step(self, params, cfg, cache, tokens):
        logits, cache = self._model.decode_step(params, cfg, cache, tokens)
        if tokens.shape[0] > 1:
            lg = logits[:, 0].float()
            top = lg.topk(2, -1)
            self.steps.append({
                "top": top.indices[:, 0].tolist(),
                "gap": (top.values[:, 0] - top.values[:, 1]).tolist(),
                "max_abs": lg.abs().amax(-1).tolist()})
        return logits, cache


def _serve(cs, dev, sz, cfg, params, attend=None):
    """Greedy tokens of the scenario's requests and the recorded steps,
    with ``attend`` in place of ``paged_attention`` when given."""
    from repro_torch.api import FaultPolicy, Strategy
    from repro_torch.models import attention as attn_mod
    from repro_torch.serving.engine import ServingEngine
    kernel_fn = attn_mod.paged_attention
    if attend is not None:
        attn_mod.paged_attention = attend
    try:
        eng = ServingEngine(
            cfg, params, max_batch=sz.max_batch,
            max_len=sz.pages_per_seq * cfg.kv_page_tokens,
            pool_frames=sz.pool_frames,
            policy=FaultPolicy(strategy=Strategy.TOUCH_AHEAD, lookahead=4),
            device=dev)
        steps: list = []
        eng.model = _Recorder(eng.model, steps)
        reqs = [eng.submit(p, max_new_tokens=sz.max_new)
                for p in cs._prompts(sz.prompts, cfg.vocab_size)]
        eng.run_until_done()
    finally:
        attn_mod.paged_attention = kernel_fn
    return [r.generated for r in reqs], steps


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="h2o_danube_1_8b")
    ap.add_argument("--layers", type=int, nargs="+", default=[12])
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("bf16_tie_check: needs a CUDA device", file=sys.stderr)
        return 1
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import chip_smoke as cs
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref
    from repro_torch.models import decoder
    from repro_torch.tree import tree_map
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    sz = cs.Sizes()
    for n_layers in args.layers:
        cfg = cs._arch_config(sz, args.arch, sliding_window=0,
                              n_layers=n_layers)
        params = decoder.init_params(cfg, 0, device=dev)
        checked = {"calls": 0, "beyond_tolerance": 0, "max_abs_err": 0.0}
        tok_k, steps_k = _serve(cs, dev, sz, cfg, params,
                                cs._checked_paged_attention(checked))
        tok_p, steps_p = _serve(cs, dev, sz, cfg, params,
                                paged_attention_ref)
        first = None
        for i, (a, b) in enumerate(zip(steps_k, steps_p)):
            if a["top"] != b["top"]:
                first = {"batch_step": i, "kernel": a, "plain": b}
                break
        fcfg = dataclasses.replace(cfg, dtype="float32")
        fparams = tree_map(lambda t: t.float(), params)
        f_k, _ = _serve(cs, dev, sz, fcfg, fparams)
        f_p, _ = _serve(cs, dev, sz, fcfg, fparams, paged_attention_ref)
        print(json.dumps({
            "arch": cfg.name, "layers": n_layers, "window": "off",
            "bf16_tokens_equal": [a == b for a, b in zip(tok_k, tok_p)],
            "bf16_kernel_calls_against_plain": checked,
            "first_differing_batch_step": first,
            "float32_tokens_equal": [a == b for a, b in zip(f_k, f_p)]}),
            flush=True)
        del params, fparams
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
