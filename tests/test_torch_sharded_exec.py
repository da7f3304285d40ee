"""Port vs reference, end-to-end sharded execution: the twin of
``tests/test_sharded_exec.py``.

The reduced codeqwen config of the reference's test (8 query and 8 KV heads
of 16, d 64, pages of 8 tokens) runs one decode step and one train step
(2 microbatches, remat, AdamW) under a (2 data x 4 model) DeviceMesh, every
parameter a DTensor with the placements of ``param_shardings`` and the
decode cache with those of ``cache_shardings``, under the reference test's
logical rules.  The weights are the reference's ``init_params``, carried
across with ``from_jax_params``.

The parent test process computes, once, the reference's single-device
results (JAX) and the port's unsharded ones, and hands them to the ranks as
``.npy`` files; this file, run as a script, is one ``gloo`` rank process
(rendezvous through a ``file://`` store), and eight of them share one
module-scoped group for every check.  Tolerances: against the reference,
its test's own (logits ``atol=2e-4, rtol=2e-3``, ``k_pool`` ``1e-5``, loss
``1e-4``, parameters ``5e-3``); against the unsharded port, f32 ``2e-5``;
the cache's ``page_table`` and ``lengths`` exactly.  The pools are compared
after the step twice: with the cache laid out as ``cache_shardings`` says
(the paged region's placements) and replicated (the region redistributes a
copy, and the write must reach the caller's pools all the same).

Two more train steps take the flash region's sequence split: reduced
Qwen3 and a reduced H2O-Danube (window 6 over 16 tokens), each with 6
query and 2 KV heads, which do not divide ``model`` = 4, so each model
rank attends with its quarter of the query rows at its offset over the
whole K/V (``SPLIT``), against the reference's and the port's unsharded
steps at the same tolerances.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
WORLD, MESH = 8, (2, 4)
B, CTX, START = 4, 32, 9              # decode: batch, context, lengths
TRAIN_SHAPE = (8, 16)                 # train: global batch x seq
RULES = {"batch": "data", "heads": "model", "kv_heads": "model",
         "ff": "model"}
SMALL = dict(n_layers=2, n_heads=8, n_kv_heads=8, head_dim=16, d_model=64,
             kv_page_tokens=8)
REF_TOL = {"logits": dict(atol=2e-4, rtol=2e-3), "pool": dict(atol=1e-5),
           "loss": dict(atol=1e-4, rtol=1e-4), "params": dict(atol=5e-3)}
PORT_TOL = dict(atol=2e-5, rtol=2e-5)
LR = 1e-3
#: heads that do not divide ``model`` = 4: the flash region splits the
#: query sequence (4 rows a rank of the 16) and passes each rank's offset
SPLIT = {"qwen3_14b": dict(n_layers=2, n_heads=6, n_kv_heads=2, head_dim=16,
                           d_model=64),
         "h2o_danube_1_8b": dict(n_layers=2, n_heads=6, n_kv_heads=2,
                                 head_dim=16, d_model=64, sliding_window=6)}


# ---------------------------------------------------------------------------
# trees as .npy files
# ---------------------------------------------------------------------------
def _flat(tree, prefix: str = "") -> dict:
    if isinstance(tree, dict):
        return {n: a for k in sorted(tree)
                for n, a in _flat(tree[k], f"{prefix}{k}.").items()}
    return {prefix[:-1]: np.asarray(tree)}


def save_tree(d: Path, name: str, tree) -> None:
    for key, a in _flat(tree).items():
        np.save(d / f"{name}.{key}.npy", np.ascontiguousarray(a))


def load_tree(d: Path, name: str) -> dict:
    out: dict = {}
    for f in sorted(d.glob(f"{name}.*.npy")):
        keys = f.name[len(name) + 1:-len(".npy")].split(".")
        node = out
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = np.load(f)
    return out


def _port_cfg(arch: str = "codeqwen15_7b"):
    from repro_torch.configs import all_configs
    from repro_torch.models.config import reduced
    return reduced(all_configs()[arch], **SPLIT.get(arch, SMALL))


def _train_cfg():
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.training.trainer import TrainConfig
    return TrainConfig(microbatches=2, remat=True,
                       optimizer=AdamWConfig(lr=LR))


def _to_numpy(tree):
    from repro_torch.compat import torch_to_numpy
    from repro_torch.tree import tree_map
    return tree_map(torch_to_numpy, tree)


def port_decode(params, cache, tokens):
    """The port's decode step on trees of tensors -> (logits, cache)."""
    from repro_torch.models.registry import model_for
    cfg = _port_cfg()
    return model_for(cfg).decode_step(params, cfg, cache, tokens)


def port_train(params, tokens, labels, arch: str = "codeqwen15_7b"):
    """The port's train step of ``arch``'s reduced config -> (params,
    loss, the gradients it handed to AdamW)."""
    from repro_torch.optim import adamw
    from repro_torch.training.trainer import make_train_step
    tcfg = _train_cfg()
    opt = adamw.init(tcfg.optimizer, params)
    seen = {}
    update = adamw.update

    def recording_update(cfg, state, p, grads):
        seen["grads"] = grads
        return update(cfg, state, p, grads)

    adamw.update = recording_update
    try:
        params, _, metrics = make_train_step(_port_cfg(arch), tcfg)(
            params, opt, tokens, labels)
    finally:
        adamw.update = update
    return params, metrics["loss"], seen["grads"]


# ---------------------------------------------------------------------------
# the parent: reference and unsharded port, once
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def single(tmp_path_factory):
    """The reference's single-device decode and train step (JAX) and the
    port's unsharded ones, on the reference's weights, saved as ``.npy``
    files; returns their directory."""
    import jax
    import jax.numpy as jnp
    import torch
    from repro.configs import all_configs as ref_configs
    from repro.models.config import reduced as ref_reduced
    from repro.models.registry import model_for as ref_model_for
    from repro.optim import adamw as ref_adamw
    from repro.optim.adamw import AdamWConfig as RefAdamWConfig
    from repro.training.trainer import TrainConfig as RefTrainConfig
    from repro.training.trainer import make_train_step as ref_train_step
    from repro_torch.compat import from_jax_params

    d = tmp_path_factory.mktemp("sharded_exec")
    cfg = ref_reduced(ref_configs()["codeqwen15_7b"], **SMALL)
    model = ref_model_for(cfg)
    params = jax.tree_util.tree_map(
        np.asarray, model.init_params(cfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)
    tk = rng.integers(0, cfg.vocab_size, TRAIN_SHAPE).astype(np.int32)
    lb = np.roll(tk, -1, axis=1)
    cache0 = jax.tree_util.tree_map(
        np.asarray, model.init_decode_cache(cfg, B, CTX))
    cache0["lengths"] = np.full((B,), START, np.int32)
    save_tree(d, "params", params)
    save_tree(d, "cache0", cache0)
    for name, a in (("tokens", tokens), ("train_tokens", tk),
                    ("train_labels", lb)):
        np.save(d / f"{name}.npy", a)

    jp, jc = (jax.tree_util.tree_map(jnp.asarray, t) for t in (params, cache0))
    logits, cache = model.decode_step(jp, cfg, jc, jnp.asarray(tokens))
    tcfg = RefTrainConfig(microbatches=2, remat=True,
                          optimizer=RefAdamWConfig(lr=LR))
    p1, _, m1 = jax.jit(ref_train_step(cfg, tcfg))(
        jp, ref_adamw.init(tcfg.optimizer, jp), jnp.asarray(tk),
        jnp.asarray(lb))
    save_tree(d, "ref_decode", {"logits": logits, **{
        k: cache[k] for k in ("k_pool", "v_pool", "page_table", "lengths")}})
    save_tree(d, "ref_train", {"loss": m1["loss"], "params": p1})

    tp, tc = (from_jax_params(t, device="cpu") for t in (params, cache0))
    logits, cache = port_decode(tp, tc, torch.from_numpy(tokens))
    save_tree(d, "port_decode", _to_numpy({"logits": logits, **{
        k: cache[k] for k in ("k_pool", "v_pool", "page_table", "lengths")}}))
    p1, loss, grads = port_train(from_jax_params(params, device="cpu"),
                                 torch.from_numpy(tk), torch.from_numpy(lb))
    save_tree(d, "port_train", _to_numpy({"loss": loss, "params": p1,
                                          "grads": grads}))

    # the sequence split's configs: the same batch, their own weights
    for arch, over in SPLIT.items():
        cfg = ref_reduced(ref_configs()[arch], **over)
        params = jax.tree_util.tree_map(
            np.asarray, ref_model_for(cfg).init_params(
                cfg, jax.random.PRNGKey(2)))
        save_tree(d, f"params_{arch}", params)
        p1, _, m1 = jax.jit(ref_train_step(cfg, tcfg))(
            jax.tree_util.tree_map(jnp.asarray, params),
            ref_adamw.init(tcfg.optimizer, params), jnp.asarray(tk),
            jnp.asarray(lb))
        save_tree(d, f"ref_train_{arch}", {"loss": m1["loss"], "params": p1})
        p1, loss, grads = port_train(from_jax_params(params, device="cpu"),
                                     torch.from_numpy(tk),
                                     torch.from_numpy(lb), arch)
        save_tree(d, f"port_train_{arch}", _to_numpy(
            {"loss": loss, "params": p1, "grads": grads}))
    return d


class TestUnshardedPort:
    """The end of the chain: the port without a mesh against the reference,
    at the reference test's tolerances (and f32 where it is tighter)."""

    def test_decode(self, single):
        ref, port = load_tree(single, "ref_decode"), \
            load_tree(single, "port_decode")
        np.testing.assert_allclose(port["logits"], ref["logits"],
                                   **REF_TOL["logits"])
        for k in ("k_pool", "v_pool"):
            np.testing.assert_allclose(port[k], ref[k], **REF_TOL["pool"])
        for k in ("page_table", "lengths"):
            np.testing.assert_array_equal(port[k], ref[k])

    def test_train_step(self, single):
        self._train_step(single, "")

    @pytest.mark.parametrize("arch", sorted(SPLIT))
    def test_train_step_of_the_split_configs(self, single, arch):
        self._train_step(single, f"_{arch}")

    @staticmethod
    def _train_step(single, name: str):
        ref, port = load_tree(single, f"ref_train{name}"), \
            load_tree(single, f"port_train{name}")
        np.testing.assert_allclose(port["loss"], ref["loss"],
                                   **REF_TOL["loss"])
        for key, want in _flat(ref["params"]).items():
            np.testing.assert_allclose(_flat(port["params"])[key], want,
                                       **REF_TOL["params"], err_msg=key)


# ---------------------------------------------------------------------------
# the ranks: one module-scoped group of eight
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def ranks(single):
    """Run this file as ``WORLD`` gloo rank processes over ``single``'s
    files; every rank prints one JSON object of check -> error text (""
    when it passed)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, __file__, str(r), str(single)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for r in range(WORLD)]
    results = {}
    try:
        for r, p in enumerate(procs):
            out, err = p.communicate(timeout=240)
            assert p.returncode == 0, f"rank {r}: {err[-3000:]}"
            results[r] = json.loads(out.strip().splitlines()[-1])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return results


def _check(results: dict, name: str) -> None:
    errors = [f"rank {r}: {res[name]}" for r, res in results.items()
              if res[name]]
    assert not errors, "\n".join(errors)


class TestShardedExec:
    def test_constrain_reduces_a_partial_dtensor(self, ranks):
        _check(ranks, "constrain_partial")

    def test_ring_decode_of_a_sliding_window_arch(self, ranks):
        _check(ranks, "ring_decode")

    def test_decode_cache_laid_out_as_the_region(self, ranks):
        _check(ranks, "decode_region_layout")

    def test_decode_cache_laid_out_otherwise(self, ranks):
        _check(ranks, "decode_other_layout")

    def test_train_step(self, ranks):
        _check(ranks, "train")

    @pytest.mark.parametrize("arch", sorted(SPLIT))
    def test_train_step_with_the_query_sequence_split(self, ranks, arch):
        _check(ranks, f"train_split_{arch}")


def test_chip_phase_runs_on_the_cpu_at_reduced_width(capsys):
    """``chip_smoke.py``'s ``dist_step`` phase at reduced width over a
    one-rank gloo group: on the CPU every call is the plain version, so no
    launch is counted, and the DTensor runs equal the plain ones."""
    import torch
    import chip_smoke
    sz = chip_smoke.Sizes(full_width=False, train_seq=64)
    table = [{"name": n} for n in ("paged_attention", "flash_attention",
                                   "flash_attention_bwd")]
    chip_smoke.phase_dist_step(torch.device("cpu"), sz, table)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["phase"] == "dist_step" and line["backend"] == "gloo"
    assert line["mesh"] == {"data": 1, "model": 1}
    assert line["rules"]["heads"] == "model"
    assert all(v == {} for v in line["launches"].values())
    assert max(line["max_abs_err"].values()) <= line["tolerance"]
    for row in table:
        assert row["launches_by_path"] == {"dist_step": 0}
    assert not torch.distributed.is_initialized()


# ---- the rank process ------------------------------------------------------
CHECKS = ("constrain_partial", "decode_region_layout", "decode_other_layout",
          "ring_decode", "train") + tuple(f"train_split_{a}" for a in SPLIT)


def _rank_checks(rank: int, d: Path) -> dict:
    import datetime
    import traceback

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    store = d / "store"
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=WORLD,
                            timeout=datetime.timedelta(seconds=120))
    try:
        mesh = init_device_mesh("cpu", MESH, mesh_dim_names=("data", "model"))
        out = dict.fromkeys(CHECKS, "not run: an earlier check failed")
        for name in CHECKS:
            try:
                if name.startswith("train_split_"):
                    _train_split(mesh, d, name[len("train_split_"):])
                else:
                    globals()[f"_{name}"](mesh, d)
                out[name] = ""
            except Exception:       # reported; the peers' collectives fail
                out[name] = traceback.format_exc()[-2500:]
                break
        return out
    finally:
        dist.destroy_process_group()


def _distribute(tree, shardings):
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.tree import tree_map
    return tree_map(lambda t, sh: distribute_tensor(t, sh.mesh,
                                                    sh.placements),
                    tree, shardings)


def _close(got, want, tol: dict, what: str) -> None:
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **tol,
                               err_msg=what)


def _constrain_partial(mesh, d) -> None:
    import torch
    from torch.distributed.tensor import (DTensor, Partial, Replicate,
                                          Shard, distribute_tensor)
    from repro_torch.distributed.logical import constrain, logical_rules
    full = torch.arange(4 * 3 * 8, dtype=torch.float32).reshape(4, 3, 8)
    # each model rank holds a quarter of the sum: full / 4
    x = DTensor.from_local(full / 4, mesh, [Replicate(), Partial()],
                           run_check=False)
    names = ("batch", "seq", "embed")
    assert constrain(x, *names) is x                      # no policy
    with logical_rules(mesh, {}):                         # an all-None spec
        y = constrain(x, *names)
        assert tuple(y.placements) == (Replicate(), Replicate())
        assert torch.equal(y.to_local(), full)
        z = distribute_tensor(full, mesh, [Shard(0), Replicate()])
        assert constrain(z, *names) is z                  # not Partial
    with logical_rules(mesh, RULES):
        y = constrain(x, *names)
        assert tuple(y.placements) == (Shard(0), Replicate())
        assert torch.equal(y.full_tensor(), full)


def _decode(mesh, d, replicated_cache: bool) -> None:
    import torch
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch.compat import from_jax_params
    from repro_torch.distributed.logical import logical_rules
    from repro_torch.distributed.sharding import (NamedSharding,
                                                  cache_shardings,
                                                  param_shardings)
    from repro_torch.distributed.logical import PartitionSpec as P
    from repro_torch.tree import tree_map
    params = from_jax_params(load_tree(d, "params"), device="cpu")
    cache = from_jax_params(load_tree(d, "cache0"), device="cpu")
    dp = _distribute(params, param_shardings(params, mesh))
    c_sh = cache_shardings(cache, mesh, B)
    if replicated_cache:
        c_sh = tree_map(lambda t: NamedSharding(mesh, P()), cache)
    dc = _distribute(cache, c_sh)
    k_local = dc["k_pool"].to_local()
    tokens = DTensor.from_local(
        torch.from_numpy(np.load(d / "tokens.npy")), mesh,
        [Replicate(), Replicate()], run_check=False).redistribute(
        mesh, [Shard(0), Replicate()])
    with logical_rules(mesh, RULES):
        logits, new = port_decode(dp, dc, tokens)
    assert isinstance(logits, DTensor)
    # the cache's pools were written in place, with the cache's placements
    assert new["k_pool"] is dc["k_pool"]
    assert new["k_pool"].to_local().data_ptr() == k_local.data_ptr()
    assert tuple(new["k_pool"].placements) == \
        tuple(c_sh["k_pool"].placements)
    if not replicated_cache:
        assert tuple(c_sh["k_pool"].placements) == (Shard(1), Shard(3))
    ref, port = load_tree(d, "ref_decode"), load_tree(d, "port_decode")
    got = {"logits": logits.full_tensor().numpy(),
           **{k: new[k].full_tensor().numpy()
              for k in ("k_pool", "v_pool", "page_table", "lengths")}}
    _close(got["logits"], ref["logits"], REF_TOL["logits"], "logits vs ref")
    _close(got["logits"], port["logits"], PORT_TOL, "logits vs port")
    for k in ("k_pool", "v_pool"):
        _close(got[k], ref[k], REF_TOL["pool"], f"{k} vs ref")
        _close(got[k], port[k], PORT_TOL, f"{k} vs port")
    for k in ("page_table", "lengths"):
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
        np.testing.assert_array_equal(got[k], port[k], err_msg=k)


def _decode_region_layout(mesh, d) -> None:
    _decode(mesh, d, replicated_cache=False)
    # a cache made under the rules is laid out by cache_shardings already
    import torch
    from torch.distributed.tensor import DTensor
    from repro_torch.distributed.logical import logical_rules
    from repro_torch.distributed.sharding import cache_shardings
    from repro_torch.models.registry import model_for
    from repro_torch.tree import tree_leaves
    cfg = _port_cfg()
    plain = model_for(cfg).init_decode_cache(cfg, B, CTX, device="cpu")
    with logical_rules(mesh, RULES):
        made = model_for(cfg).init_decode_cache(cfg, B, CTX, device="cpu")
    for t, p, sh in zip(tree_leaves(made), tree_leaves(plain),
                        tree_leaves(cache_shardings(plain, mesh, B))):
        assert isinstance(t, DTensor)
        assert tuple(t.placements) == tuple(sh.placements)
        assert torch.equal(t.full_tensor(), p)


def _decode_other_layout(mesh, d) -> None:
    _decode(mesh, d, replicated_cache=True)


def _ring_decode(mesh, d) -> None:
    """A sliding-window arch (reduced H2O-Danube: the decoder keeps a ring
    buffer, not the paged pools) decodes sharded as the port does
    unsharded.  The ring's cache layout (head_dim over ``model``) is not
    the region's (heads), so the written ring is copied back."""
    import torch
    from torch.distributed.tensor import Shard
    from repro_torch.configs import all_configs
    from repro_torch.distributed.logical import logical_rules
    from repro_torch.distributed.sharding import (cache_shardings,
                                                  param_shardings)
    from repro_torch.models import decoder
    from repro_torch.models.config import reduced
    from repro_torch.tree import tree_map
    cfg = reduced(all_configs()["h2o_danube_1_8b"], n_heads=8, n_kv_heads=4)
    assert decoder.uses_ring(cfg)
    params = decoder.init_params(cfg, 3, device="cpu")
    cache = decoder.init_decode_cache(cfg, B, CTX, device="cpu")
    gen = torch.Generator().manual_seed(4)
    for k in ("k_ring", "v_ring"):
        cache[k].copy_(torch.randn(cache[k].shape, generator=gen))
    cache["lengths"] = torch.tensor([40, 41, 12, 33], dtype=torch.int32)
    tokens = torch.randint(0, cfg.vocab_size, (B, 1), generator=gen)
    want, want_cache = decoder.decode_step(
        params, cfg, tree_map(torch.clone, cache), tokens)
    c_sh = cache_shardings(cache, mesh, B)
    assert tuple(c_sh["k_ring"].placements) == (Shard(1), Shard(4))
    dc = _distribute(cache, c_sh)
    with logical_rules(mesh, RULES):
        got, _ = decoder.decode_step(
            _distribute(params, param_shardings(params, mesh)), cfg, dc,
            _distribute({"t": tokens}, {"t": _token_sharding(mesh)})["t"])
    _close(got.full_tensor(), want, PORT_TOL, "ring logits vs port")
    for k in ("k_ring", "v_ring"):
        _close(dc[k].full_tensor(), want_cache[k], PORT_TOL,
               f"{k} vs port")


def _token_sharding(mesh):
    from repro_torch.distributed.sharding import token_sharding
    return token_sharding(mesh)


def _train(mesh, d) -> None:
    """The step against the reference (loss, parameters) and against the
    unsharded port: the loss and every gradient the step hands to AdamW
    at f32; AdamW over DTensors, given the unsharded step's gradients, at
    f32; the parameters after the whole step at the reference test's
    bound.  (A gradient that cancels to ~eps, 2.4e-8 against AdamW's 1e-8,
    turns a sum-order difference of 1e-9 into a 3.8e-5 step: the one
    element of 16,384 in ``wq`` that a whole-step f32 bound would fail.)"""
    import torch
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch.compat import from_jax_params
    from repro_torch.distributed.logical import logical_rules
    from repro_torch.distributed.sharding import param_shardings
    from repro_torch.optim import adamw
    from repro_torch.tree import tree_leaves, tree_names
    params = from_jax_params(load_tree(d, "params"), device="cpu")
    p_sh = param_shardings(params, mesh)
    dp = _distribute(params, p_sh)

    def batch(name):
        return DTensor.from_local(
            torch.from_numpy(np.load(d / f"{name}.npy")), mesh,
            [Replicate(), Replicate()], run_check=False).redistribute(
            mesh, [Shard(0), Replicate()])

    with logical_rules(mesh, RULES):
        p1, loss, grads = port_train(dp, batch("train_tokens"),
                                     batch("train_labels"))
    assert not isinstance(loss, DTensor) and loss.ndim == 0
    for t in (p1, grads):
        for p, sh in zip(tree_leaves(t), tree_leaves(p_sh)):
            assert tuple(p.placements) == tuple(sh.placements)
    ref, port = load_tree(d, "ref_train"), load_tree(d, "port_train")
    _close(float(loss), ref["loss"], REF_TOL["loss"], "loss vs ref")
    _close(float(loss), port["loss"], PORT_TOL, "loss vs port")
    names = [n.replace("/", ".") for n in tree_names(p1)]
    for part, tree, tol in (("params", p1, REF_TOL["params"]),
                            ("grads", grads, PORT_TOL)):
        want = _flat(port[part])
        for key, t in zip(names, tree_leaves(tree)):
            _close(t.full_tensor().numpy(), want[key], tol,
                   f"{part} {key} vs port")
    got = dict(zip(names, (p.full_tensor().numpy() for p in tree_leaves(p1))))
    for key, want in _flat(ref["params"]).items():
        _close(got[key], want, REF_TOL["params"], f"{key} vs ref")
    # AdamW over DTensors on the unsharded step's gradients
    tcfg = _train_cfg()
    dp = _distribute(from_jax_params(load_tree(d, "params"), device="cpu"),
                     p_sh)
    g = _distribute(from_jax_params(port["grads"], device="cpu"), p_sh)
    dp, _, _ = adamw.update(tcfg.optimizer, adamw.init(tcfg.optimizer, dp),
                            dp, g)
    want = _flat(port["params"])
    for key, t in zip(names, tree_leaves(dp)):
        _close(t.full_tensor().numpy(), want[key], PORT_TOL,
               f"AdamW {key} vs port")



def _train_split(mesh, d, arch: str) -> None:
    """``arch``'s reduced config, whose 6 query heads do not divide
    ``model`` = 4: the flash region splits the query sequence, and every
    call it makes takes this rank's rows at offset ``model rank x S / 4``
    (recorded), forward and remat recompute.  The step's loss and every
    gradient against the unsharded port at f32, the loss and the updated
    parameters against the reference at its test's bounds."""
    import torch
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch.compat import from_jax_params
    from repro_torch.distributed.logical import logical_rules
    from repro_torch.distributed.sharding import param_shardings
    from repro_torch.models import attention
    from repro_torch.tree import tree_leaves, tree_names
    params = from_jax_params(load_tree(d, f"params_{arch}"), device="cpu")
    p_sh = param_shardings(params, mesh)
    dp = _distribute(params, p_sh)

    def batch(name):
        return DTensor.from_local(
            torch.from_numpy(np.load(d / f"{name}.npy")), mesh,
            [Replicate(), Replicate()], run_check=False).redistribute(
            mesh, [Shard(0), Replicate()])

    seen = []
    flash = attention.flash_attention

    def recording(q, k, v, **kw):
        seen.append((kw.get("q_offset"), q.shape[1], k.shape[1]))
        return flash(q, k, v, **kw)

    attention.flash_attention = recording
    try:
        with logical_rules(mesh, RULES):
            p1, loss, grads = port_train(dp, batch("train_tokens"),
                                         batch("train_labels"), arch)
    finally:
        attention.flash_attention = flash
    S = TRAIN_SHAPE[1]
    rows = S // MESH[1]
    offset = mesh.get_local_rank("model") * rows
    assert seen and set(seen) == {(offset, rows, S)}, seen
    ref, port = load_tree(d, f"ref_train_{arch}"), \
        load_tree(d, f"port_train_{arch}")
    _close(float(loss), ref["loss"], REF_TOL["loss"], "loss vs ref")
    _close(float(loss), port["loss"], PORT_TOL, "loss vs port")
    names = [n.replace("/", ".") for n in tree_names(p1)]
    want = _flat(port["grads"])
    for key, t in zip(names, tree_leaves(grads)):
        _close(t.full_tensor().numpy(), want[key], PORT_TOL,
               f"grads {key} vs port")
    got = dict(zip(names, (p.full_tensor().numpy() for p in tree_leaves(p1))))
    for key, w in _flat(ref["params"]).items():
        _close(got[key], w, REF_TOL["params"], f"{key} vs ref")


if __name__ == "__main__":
    rank, d = sys.argv[1:3]
    print(json.dumps(_rank_checks(int(rank), Path(d))))
