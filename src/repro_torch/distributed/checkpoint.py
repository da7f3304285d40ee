"""Checkpointing with the reference's on-disk layout, atomic and gc'd.

Layout (one directory per step), the same as the reference's, so a
checkpoint written by either package restores in the other::

    <dir>/step_000123/
        manifest.json      leaf names, shapes, dtypes, hosts, step
        shard_h000.npz     this host's leaf shards (all leaves, one file)

Leaf names are the tree paths in sorted-key order, ``params/...`` and
``opt/{mu,nu,step}/...``, stored under ``params::...`` keys.  Writes go to
``step_N.tmp`` and are renamed into place; all but the last three steps
are removed.

bfloat16 leaves: numpy has no bfloat16, and the reference's own writer
stores one as raw 2-byte records that its restore cannot read back.  The
port writes a bfloat16 leaf as float32 (exact: every bfloat16 is a
float32), which both packages restore by casting to the leaf's dtype; the
manifest still says ``bfloat16``.  It reads the reference's 2-byte records
by their bits.  So the port needs no ``ml_dtypes`` here.

Leaves are moved to the host and written one at a time (and read back one
at a time into the given tensors, in place), so a full-width state never
has a second copy in host memory.
"""

from __future__ import annotations

import json
import os
import shutil
import zipfile
from typing import Optional

import numpy as np
import torch

from repro_torch.compat import dtype_name
from repro_torch.optim.adamw import AdamWState
from repro_torch.tree import tree_leaves, tree_names

MANIFEST = "manifest.json"


def _state_tree(params, opt_state: Optional[AdamWState]) -> dict:
    state = {"params": params}
    if opt_state is not None:
        state["opt"] = {"step": opt_state.step, "mu": opt_state.mu,
                        "nu": opt_state.nu}
    return state


def _to_host(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.to("cpu").contiguous().numpy()


def _from_host(arr: np.ndarray) -> torch.Tensor:
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:
        # the reference's bfloat16 leaf: raw 2-byte records
        return torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)) \
            .view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(arr))


def _write_npz(path: str, items) -> None:
    """``np.savez`` written member by member from an iterator, so only one
    leaf is on the host at a time; ``np.load`` reads it as usual."""
    with zipfile.ZipFile(path, mode="w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for key, arr in items:
            with zf.open(key + ".npy", mode="w", force_zip64=True) as f:
                np.lib.format.write_array(f, arr, allow_pickle=False)


class Checkpointer:
    def __init__(self, host_id: int = 0, n_hosts: int = 1):
        self.host_id = host_id
        self.n_hosts = n_hosts

    # ------------------------------------------------------------------ save
    def _host_shard(self, arr: np.ndarray) -> np.ndarray:
        # host shard: contiguous split on dim 0 when divisible
        if self.n_hosts > 1 and arr.ndim and arr.shape[0] % self.n_hosts == 0:
            k = arr.shape[0] // self.n_hosts
            arr = arr[self.host_id * k:(self.host_id + 1) * k]
        return arr

    def save(self, directory: str, params, opt_state: Optional[AdamWState],
             step: int) -> str:
        os.makedirs(directory, exist_ok=True)
        final = os.path.join(directory, f"step_{step:08d}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)

        state = _state_tree(params, opt_state)
        names, leaves = tree_names(state), tree_leaves(state)
        manifest = {
            "step": step,
            "n_hosts": self.n_hosts,
            "leaves": [{"name": n, "shape": list(l.shape),
                        "dtype": dtype_name(l.dtype)}
                       for n, l in zip(names, leaves)],
        }
        items = ((n.replace("/", "::"), self._host_shard(_to_host(l)))
                 for n, l in zip(names, leaves))
        shard = f"shard_h{self.host_id:03d}.npz"
        if os.path.isdir(final):
            # another host already published this step: add our shard
            _write_npz(os.path.join(final, shard), items)
            if self.host_id == 0:
                with open(os.path.join(final, MANIFEST), "w") as f:
                    json.dump(manifest, f, indent=1)
            shutil.rmtree(tmp, ignore_errors=True)
            self._gc(directory, keep=3)
            return final
        _write_npz(os.path.join(tmp, shard), items)
        if self.host_id == 0 or self.n_hosts == 1:
            with open(os.path.join(tmp, MANIFEST), "w") as f:
                json.dump(manifest, f, indent=1)
        try:
            os.replace(tmp, final)     # atomic publish
        except OSError:
            # lost the publish race: merge our shard into the winner
            for fn in os.listdir(tmp):
                os.replace(os.path.join(tmp, fn), os.path.join(final, fn))
            shutil.rmtree(tmp, ignore_errors=True)
        self._gc(directory, keep=3)
        return final

    def _gc(self, directory: str, keep: int) -> None:
        steps = sorted(d for d in os.listdir(directory)
                       if d.startswith("step_") and not d.endswith(".tmp"))
        for d in steps[:-keep]:
            shutil.rmtree(os.path.join(directory, d), ignore_errors=True)

    # --------------------------------------------------------------- restore
    def latest_step(self, directory: str) -> Optional[int]:
        if not os.path.isdir(directory):
            return None
        steps = sorted(int(d.split("_")[1]) for d in os.listdir(directory)
                       if d.startswith("step_") and not d.endswith(".tmp"))
        return steps[-1] if steps else None

    def restore(self, directory: str, step: int, params_like,
                opt_like: Optional[AdamWState] = None,
                n_saved_hosts: Optional[int] = None):
        """Restore **in place** into the tensors of ``params_like`` (and
        ``opt_like``), each cast to its own dtype on its own device;
        returns ``(params_like, opt_like, step)``.  Elastic: the number of
        restoring hosts may differ from the saving hosts."""
        path = os.path.join(directory, f"step_{step:08d}")
        with open(os.path.join(path, MANIFEST)) as f:
            manifest = json.load(f)
        n_saved = n_saved_hosts or manifest["n_hosts"]
        shards = []
        for h in range(n_saved):
            fp = os.path.join(path, f"shard_h{h:03d}.npz")
            if os.path.exists(fp):
                shards.append(np.load(fp))
        shapes = {l["name"]: tuple(l["shape"]) for l in manifest["leaves"]}
        state = _state_tree(params_like, opt_like)
        with torch.no_grad():
            for n, like in zip(tree_names(state), tree_leaves(state)):
                key = n.replace("/", "::")
                parts = [s[key] for s in shards if key in s]
                if len(parts) == 1 and parts[0].shape == shapes[n]:
                    arr = parts[0]
                else:
                    arr = np.concatenate(parts, axis=0)
                like.copy_(_from_host(arr).reshape(like.shape))
                del parts, arr
        for s in shards:
            s.close()
        return params_like, opt_like, manifest["step"]

    def restore_latest(self, directory: str, params_like, opt_like=None):
        step = self.latest_step(directory)
        if step is None:
            return None
        return self.restore(directory, step, params_like, opt_like)
