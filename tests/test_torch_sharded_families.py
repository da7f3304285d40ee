"""Port vs reference, end-to-end sharded execution of the five families
beside the dense one: Mixtral-8x7B (``moe``), DeepSeek-V3 (``mla_moe``),
Zamba2-7B (``hybrid``), Whisper-medium (``encdec``) and xLSTM-125M
(``xlstm``), each the twin of what ``tests/test_sharded_exec.py`` does for
the dense family.

Each family's reduced config (4 query heads, so that heads divide the model
axis) runs one decode step and one train step (2 microbatches, remat,
AdamW) under a (2 data x 4 model) DeviceMesh, every parameter a DTensor
with the placements of ``param_shardings``, under the arch's logical rules
(``launch.dryrun.logical_rules_for``).  Mixtral keeps 8 experts, which its
rules and weights split over ``("model", "data")`` (2-D expert
parallelism); DeepSeek-V3 keeps 4 experts and one shared expert, split over
``"model"`` (1-D).  Mixtral's train step dispatches its tokens in groups of
``GROUP_TOKENS[arch]`` (patched into both packages' ``moe`` modules), so
that the grouped, checkpointed path of ``apply_moe`` runs, its last group
padded.  The weights are the reference's ``init_params``, carried across
with ``from_jax_params``; every float leaf of the decode cache is filled
from a seeded numpy draw (the pools and the pinned states: Mamba2, xLSTM,
Whisper's cross K/V), the xLSTM normalisers ``n`` at 1 and above, as the
sums of positive gates they are in a run.

As in ``tests/test_torch_sharded_exec.py``, the parent computes the
reference's single-device results (JAX) and the port's unsharded ones
once, and this file, run as a script, is one of eight ``gloo`` rank
processes that share one module-scoped group.  Tolerances: against the
reference, its sharded test's own (logits ``atol=2e-4, rtol=2e-3``, pools
and state leaves ``1e-5``, loss ``1e-4``, parameters ``5e-3``); against the
unsharded port f32 ``2e-5`` (logits, cache leaves, loss and the gradients
handed to AdamW; the parameters after AdamW at the reference bound, for the
reason ``tests/test_torch_sharded_exec.py::_train`` gives); page tables
and lengths exactly.  The decode cache is laid out once as
``cache_shardings`` says and once replicated, and the step must write the
caller's leaves either way.
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
TRAIN_SHAPE = (8, 8)                  # train: global batch x seq
#: arch -> overrides of ``reduced`` (4 heads and 4 KV heads by default)
FAMILIES = {
    "mixtral_8x7b": {"n_experts": 8},          # 2-D EP over (model, data)
    "deepseek_v3_671b": {},                    # 4 experts + 1 shared: 1-D EP
    "zamba2_7b": {},                           # 2 groups of 2 and a tail
    "whisper_medium": {},                      # 2 + 2 layers, 16 frames
    "xlstm_125m": {},                          # an mLSTM and an sLSTM block
}
#: dispatch groups of the train step's MoE (32 tokens a microbatch: a
#: group of 24 and a padded one)
GROUP_TOKENS = {"mixtral_8x7b": 24}
#: the expert weights' spec on the (2, 4) mesh, the stacked-layer axis first
EXPERT_SPEC = {"mixtral_8x7b": (None, ("model", "data"), None, None),
               "deepseek_v3_671b": (None, "model", None, None)}
REF_TOL = {"logits": dict(atol=2e-4, rtol=2e-3), "state": dict(atol=1e-5),
           "loss": dict(atol=1e-4, rtol=1e-4), "params": dict(atol=5e-3)}
PORT_TOL = dict(atol=2e-5, rtol=2e-5)
LR = 1e-3
EXACT = ("page_table", "lengths")


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


# ---------------------------------------------------------------------------
# the port's side
# ---------------------------------------------------------------------------
def _patch_groups(arch: str, *modules) -> None:
    for m in modules:
        m.GROUP_TOKENS = GROUP_TOKENS.get(arch, 4096)


def _port_cfg(arch: str):
    from repro_torch.configs import all_configs
    from repro_torch.models import moe
    from repro_torch.models.config import reduced
    _patch_groups(arch, moe)
    return reduced(all_configs()[arch], **FAMILIES[arch])


def _train_cfg():
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.training.trainer import TrainConfig
    return TrainConfig(microbatches=2, remat=True,
                       optimizer=AdamWConfig(lr=LR))


def _slstm_segments(cfg) -> set:
    """The cache keys whose leaves the port carries as (1, B, d) where the
    reference's are (B, d) (``models/xlstm_model.py``)."""
    if cfg.family != "xlstm":
        return set()
    from repro_torch.models.xlstm_model import segments
    return {f"seg{i}" for i, s in enumerate(segments(cfg)) if s[0] == "s"}


def port_cache(cfg, ref_cache: dict) -> dict:
    """The reference's decode cache (numpy) as the port's."""
    from repro_torch.compat import from_jax_params
    slstm = _slstm_segments(cfg)
    return from_jax_params({k: ({n: a[None] for n, a in v.items()}
                                if k in slstm else v)
                            for k, v in ref_cache.items()}, device="cpu")


def as_ref_cache(cfg, flat: dict) -> dict:
    """A port cache's flat leaves with the sLSTM axis dropped."""
    slstm = _slstm_segments(cfg)
    return {k: a[0] if k.split(".")[0] in slstm else a
            for k, a in flat.items()}


def port_decode(arch: str, params, cache, tokens):
    from repro_torch.models.registry import model_for
    cfg = _port_cfg(arch)
    return model_for(cfg).decode_step(params, cfg, cache, tokens)


def port_train(arch: str, params, tokens, labels):
    """The port's train step -> (params, loss, the gradients it handed to
    AdamW)."""
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


def _to_numpy(tree):
    from repro_torch.compat import torch_to_numpy
    from repro_torch.tree import tree_map
    return tree_map(torch_to_numpy, tree)


# ---------------------------------------------------------------------------
# the parent: reference and unsharded port, once per family
# ---------------------------------------------------------------------------
def _ref_model(arch: str):
    """The reference's reduced config and model of ``arch``."""
    from repro.configs import all_configs as ref_configs
    from repro.models import moe as ref_moe
    from repro.models.config import reduced as ref_reduced
    from repro.models.registry import model_for as ref_model_for
    _patch_groups(arch, ref_moe)
    cfg = ref_reduced(ref_configs()[arch], **FAMILIES[arch])
    return cfg, ref_model_for(cfg)


def _inputs(arch: str, d: Path) -> None:
    """The reference's weights, the decode cache (every float leaf drawn),
    the decode tokens and the train batch, as ``.npy`` files in ``d``."""
    import jax
    cfg, model = _ref_model(arch)
    params = jax.tree_util.tree_map(
        np.asarray, model.init_params(cfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)
    tk = rng.integers(0, cfg.vocab_size, TRAIN_SHAPE).astype(np.int32)
    cache0 = {}
    for key, a in _flat(jax.tree_util.tree_map(
            np.asarray, model.init_decode_cache(cfg, B, CTX))).items():
        if key not in EXACT:
            draw = 0.5 * rng.standard_normal(a.shape)
            if key.endswith(".n"):       # an xLSTM normaliser: a sum of
                draw = 1.0 + np.abs(draw)    # positive gates, never near 0
            a = draw.astype(a.dtype)
        cache0[key] = a
    cache0["lengths"] = np.full((B,), START, np.int32)
    save_tree(d, "params", params)
    save_tree(d, "cache0", _nest(cache0))
    for name, a in (("tokens", tokens), ("train_tokens", tk),
                    ("train_labels", np.roll(tk, -1, axis=1))):
        np.save(d / f"{name}.npy", a)


def _reference_and_port(arch: str, d: Path) -> None:
    """The reference's single-device decode and train step (JAX) and the
    port's unsharded ones over ``_inputs``' files."""
    import jax
    import jax.numpy as jnp
    import torch
    from repro.optim import adamw as ref_adamw
    from repro.optim.adamw import AdamWConfig as RefAdamWConfig
    from repro.training.trainer import TrainConfig as RefTrainConfig
    from repro.training.trainer import make_train_step as ref_train_step
    from repro_torch.compat import from_jax_params

    cfg, model = _ref_model(arch)
    params, cache0 = load_tree(d, "params"), load_tree(d, "cache0")
    tokens, tk, lb = (np.load(d / f"{n}.npy") for n in (
        "tokens", "train_tokens", "train_labels"))
    jp, jc = (jax.tree_util.tree_map(jnp.asarray, t) for t in (params, cache0))
    logits, cache = model.decode_step(jp, cfg, jc, jnp.asarray(tokens))
    tcfg = RefTrainConfig(microbatches=2, remat=True,
                          optimizer=RefAdamWConfig(lr=LR))
    p1, _, m1 = jax.jit(ref_train_step(cfg, tcfg))(
        jp, ref_adamw.init(tcfg.optimizer, jp), jnp.asarray(tk),
        jnp.asarray(lb))
    save_tree(d, "ref_decode", {"logits": logits, "cache": cache})
    save_tree(d, "ref_train", {"loss": m1["loss"], "params": p1})

    pcfg = _port_cfg(arch)
    logits, cache = port_decode(arch, from_jax_params(params, device="cpu"),
                                port_cache(pcfg, cache0),
                                torch.from_numpy(tokens))
    save_tree(d, "port_decode", _to_numpy({"logits": logits,
                                           "cache": cache}))
    p1, loss, grads = port_train(arch, from_jax_params(params, device="cpu"),
                                 torch.from_numpy(tk), torch.from_numpy(lb))
    save_tree(d, "port_train", _to_numpy({"loss": loss, "params": p1,
                                          "grads": grads}))


def _nest(flat: dict) -> dict:
    out: dict = {}
    for key, a in flat.items():
        node = out
        *path, last = key.split(".")
        for k in path:
            node = node.setdefault(k, {})
        node[last] = a
    return out


@pytest.fixture(scope="module")
def rank_procs(tmp_path_factory):
    """Every family's inputs under ``<dir>/<arch>``, then this file started
    as ``WORLD`` gloo rank processes over them: they run the sharded steps
    while the parent computes ``single``.  Returns (dir, processes)."""
    d = tmp_path_factory.mktemp("sharded_families")
    for arch in FAMILIES:
        (d / arch).mkdir()
        _inputs(arch, d / arch)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, __file__, str(r), str(d)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for r in range(WORLD)]
    yield d, procs
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()


@pytest.fixture(scope="module")
def single(rank_procs):
    """Per family, the reference's and the unsharded port's results, saved
    as ``.npy`` files beside the inputs; returns their directory."""
    d = rank_procs[0]
    for arch in FAMILIES:
        _reference_and_port(arch, d / arch)
    return d


@pytest.fixture(scope="module")
def ranks(rank_procs, single):
    """Wait for the ranks: each prints one JSON object of ``arch/check`` ->
    error text ("" when its checks on the rank passed); rank 0 saved the
    global values of what each check computed."""
    results = {}
    for r, p in enumerate(rank_procs[1]):
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0, f"rank {r}: {err[-3000:]}"
        results[r] = json.loads(out.strip().splitlines()[-1])
    (single / "ranks.json").write_text(json.dumps(results))
    return single


class TestUnshardedPort:
    """The end of the chain: each family's port without a mesh against the
    reference, at the reference test's tolerances."""

    @pytest.mark.parametrize("arch", FAMILIES)
    def test_decode(self, single, arch):
        d = single / arch
        ref, port = load_tree(d, "ref_decode"), load_tree(d, "port_decode")
        np.testing.assert_allclose(port["logits"], ref["logits"],
                                   **REF_TOL["logits"])
        got = as_ref_cache(_port_cfg(arch), _flat(port["cache"]))
        for key, want in _flat(ref["cache"]).items():
            if key in EXACT:
                np.testing.assert_array_equal(got[key], want, err_msg=key)
            else:
                np.testing.assert_allclose(got[key], want, **REF_TOL["state"],
                                           err_msg=key)

    @pytest.mark.parametrize("arch", FAMILIES)
    def test_train_step(self, single, arch):
        d = single / arch
        ref, port = load_tree(d, "ref_train"), load_tree(d, "port_train")
        np.testing.assert_allclose(port["loss"], ref["loss"],
                                   **REF_TOL["loss"])
        for key, want in _flat(ref["params"]).items():
            np.testing.assert_allclose(_flat(port["params"])[key], want,
                                       **REF_TOL["params"], err_msg=key)


@pytest.mark.parametrize("arch", sorted(EXPERT_SPEC))
def test_both_expert_layouts(arch):
    """Mixtral's 8 experts split over ("model", "data") on the (2, 4) mesh,
    DeepSeek-V3's 4 over "model": the weights' specs and the rules agree,
    as ``_moe_rule_fixup`` and ``logical_rules_for`` make them."""
    import torch
    from repro_torch.distributed.logical import AbstractMesh
    from repro_torch.distributed.sharding import param_shardings
    from repro_torch.launch.dryrun import logical_rules_for
    from repro_torch.models.registry import model_for
    from repro_torch.tree import tree_leaves, tree_names
    cfg = _port_cfg(arch)
    mesh = AbstractMesh(MESH, ("data", "model"))
    params = model_for(cfg).init_params(cfg, 0, device="meta")
    specs = dict(zip(tree_names(params),
                     tree_leaves(param_shardings(params, mesh))))
    for w in ("wi", "wg", "wo"):
        assert tuple(specs[f"moe_layers/moe/{w}"].spec) == EXPERT_SPEC[arch]
    assert logical_rules_for(cfg, mesh)["experts"] == EXPERT_SPEC[arch][1]
    assert isinstance(params["embed"], torch.Tensor)


# ---------------------------------------------------------------------------
# the ranks' results against the reference and the unsharded port
# ---------------------------------------------------------------------------
def _check(d: Path, name: str) -> None:
    """Every rank's own checks of ``name`` (placements, leaves written in
    place) passed."""
    errors = [f"rank {r}: {res[name]}" for r, res in json.loads(
        (d / "ranks.json").read_text()).items() if res[name]]
    assert not errors, "\n".join(errors)


def _close(got, want, tol: dict, what: str) -> None:
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **tol,
                               err_msg=what)


class TestShardedFamilies:
    @pytest.mark.parametrize("arch", FAMILIES)
    def test_decode_cache_laid_out_as_the_region(self, ranks, arch):
        self._decode(ranks, arch, "decode_region_layout")

    @pytest.mark.parametrize("arch", FAMILIES)
    def test_decode_cache_laid_out_otherwise(self, ranks, arch):
        self._decode(ranks, arch, "decode_other_layout")

    @pytest.mark.parametrize("arch", FAMILIES)
    def test_train_step(self, ranks, arch):
        """The step against the reference (loss, parameters) and against
        the unsharded port (the loss and every gradient the step hands to
        AdamW at f32, the parameters at the reference bound); on the ranks,
        the parameters and gradients kept ``param_shardings``' placements.
        """
        _check(ranks, f"{arch}/train")
        d = ranks / arch
        got = load_tree(d, "train")
        ref, port = load_tree(d, "ref_train"), load_tree(d, "port_train")
        _close(got["loss"], ref["loss"], REF_TOL["loss"], "loss vs ref")
        _close(got["loss"], port["loss"], PORT_TOL, "loss vs port")
        for part, tol in (("params", REF_TOL["params"]), ("grads", PORT_TOL)):
            want = _flat(port[part])
            for key, t in _flat(got[part]).items():
                _close(t, want[key], tol, f"{part} {key} vs port")
        mine = _flat(got["params"])
        for key, want in _flat(ref["params"]).items():
            _close(mine[key], want, REF_TOL["params"], f"{key} vs ref")

    @staticmethod
    def _decode(d: Path, arch: str, check: str) -> None:
        """The logits and every leaf of the caller's cache after the step
        against the reference and the unsharded port."""
        _check(d, f"{arch}/{check}")
        got = load_tree(d / arch, check)
        ref = load_tree(d / arch, "ref_decode")
        port = load_tree(d / arch, "port_decode")
        _close(got["logits"], ref["logits"], REF_TOL["logits"],
               "logits vs ref")
        _close(got["logits"], port["logits"], PORT_TOL, "logits vs port")
        mine, want_port = _flat(got["cache"]), _flat(port["cache"])
        mine_ref = as_ref_cache(_port_cfg(arch), mine)
        for key, want in _flat(ref["cache"]).items():
            if key in EXACT:
                np.testing.assert_array_equal(mine[key], want, err_msg=key)
                np.testing.assert_array_equal(mine[key], want_port[key],
                                              err_msg=key)
            else:
                _close(mine_ref[key], want, REF_TOL["state"],
                       f"{key} vs ref")
                _close(mine[key], want_port[key], PORT_TOL, f"{key} vs port")


# ---- the rank process ------------------------------------------------------
CHECKS = ("decode_region_layout", "decode_other_layout", "train")


def _rank_checks(rank: int, d: Path) -> dict:
    """Run every family's checks on this rank; rank 0 saves what each
    computed (global values) under ``<dir>/<arch>/<check>.*.npy``."""
    import datetime
    import traceback

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    store = d / "store"
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=WORLD,
                            timeout=datetime.timedelta(seconds=120))
    names = [f"{a}/{c}" for a in FAMILIES for c in CHECKS]
    out = dict.fromkeys(names, "not run: an earlier check failed")
    try:
        mesh = init_device_mesh("cpu", MESH, mesh_dim_names=("data", "model"))
        for name in names:
            arch, check = name.split("/")
            try:
                got = globals()[f"_{check}"](mesh, arch, d / arch)
                if rank == 0:
                    save_tree(d / arch, check, got)
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


def _global(tree):
    """Every DTensor leaf's global value, as numpy."""
    from repro_torch.tree import tree_map
    return tree_map(lambda t: t.full_tensor().numpy(), tree)


def _rows(mesh, d: Path, name: str):
    """A (B, ...) input of ``name`` split over the data axis."""
    import torch
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.distributed.sharding import token_sharding
    return distribute_tensor(torch.from_numpy(np.load(d / f"{name}.npy")),
                             mesh, token_sharding(mesh).placements)


def _rules(mesh, arch: str) -> dict:
    from repro_torch.launch.dryrun import logical_rules_for
    return logical_rules_for(_port_cfg(arch), mesh)


def _decode(mesh, arch: str, d: Path, replicated_cache: bool) -> dict:
    """One decode step; the caller's cache must hold the step's writes in
    its own leaves and placements.  Returns the logits and that cache."""
    from torch.distributed.tensor import DTensor
    from repro_torch.compat import from_jax_params
    from repro_torch.distributed.logical import PartitionSpec as P
    from repro_torch.distributed.logical import logical_rules
    from repro_torch.distributed.sharding import (NamedSharding,
                                                  cache_shardings,
                                                  param_shardings)
    from repro_torch.tree import tree_leaves, tree_map, tree_names
    params = from_jax_params(load_tree(d, "params"), device="cpu")
    cache = port_cache(_port_cfg(arch), load_tree(d, "cache0"))
    c_sh = cache_shardings(cache, mesh, B)
    if replicated_cache:
        c_sh = tree_map(lambda t: NamedSharding(mesh, P()), cache)
    dc = _distribute(cache, c_sh)
    with logical_rules(mesh, _rules(mesh, arch)):
        logits, new = port_decode(
            arch, _distribute(params, param_shardings(params, mesh)), dc,
            _rows(mesh, d, "tokens"))
    assert isinstance(logits, DTensor)
    for name, t, held, sh in zip(tree_names(new), tree_leaves(new),
                                 tree_leaves(dc), tree_leaves(c_sh)):
        if name != "lengths":
            assert t is held, name
        assert tuple(t.placements) == tuple(sh.placements), name
    return {"logits": logits.full_tensor().numpy(),
            "cache": _global(dict(dc, lengths=new["lengths"]))}


def _decode_region_layout(mesh, arch: str, d: Path) -> dict:
    got = _decode(mesh, arch, d, replicated_cache=False)
    # a cache made under the rules is laid out by cache_shardings already
    import torch
    from torch.distributed.tensor import DTensor
    from repro_torch.distributed.logical import logical_rules
    from repro_torch.distributed.sharding import cache_shardings
    from repro_torch.models.registry import model_for
    from repro_torch.tree import tree_leaves
    cfg = _port_cfg(arch)
    plain = model_for(cfg).init_decode_cache(cfg, B, CTX, device="cpu")
    with logical_rules(mesh, _rules(mesh, arch)):
        made = model_for(cfg).init_decode_cache(cfg, B, CTX, device="cpu")
    for t, p, sh in zip(tree_leaves(made), tree_leaves(plain),
                        tree_leaves(cache_shardings(plain, mesh, B))):
        assert isinstance(t, DTensor)
        assert tuple(t.placements) == tuple(sh.placements)
        assert torch.equal(t.full_tensor(), p)
    return got


def _decode_other_layout(mesh, arch: str, d: Path) -> dict:
    return _decode(mesh, arch, d, replicated_cache=True)


def _train(mesh, arch: str, d: Path) -> dict:
    """One train step; the parameters and gradients must keep
    ``param_shardings``' placements and the loss be a plain scalar."""
    from torch.distributed.tensor import DTensor
    from repro_torch.compat import from_jax_params
    from repro_torch.distributed.logical import logical_rules
    from repro_torch.distributed.sharding import param_shardings
    from repro_torch.tree import tree_leaves
    params = from_jax_params(load_tree(d, "params"), device="cpu")
    p_sh = param_shardings(params, mesh)
    with logical_rules(mesh, _rules(mesh, arch)):
        p1, loss, grads = port_train(arch, _distribute(params, p_sh),
                                     _rows(mesh, d, "train_tokens"),
                                     _rows(mesh, d, "train_labels"))
    assert not isinstance(loss, DTensor) and loss.ndim == 0
    for t in (p1, grads):
        for p, sh in zip(tree_leaves(t), tree_leaves(p_sh)):
            assert tuple(p.placements) == tuple(sh.placements)
    return {"loss": loss.numpy(), "params": _global(p1),
            "grads": _global(grads)}


if __name__ == "__main__":
    rank, d = sys.argv[1:3]
    print(json.dumps(_rank_checks(int(rank), Path(d))))
