"""Port vs reference, remote paging: ``RemoteFramePool`` (page-ins as verbs
``post_read``s into a FAULTING landing buffer, completions on a CQ,
write-backs mirrored to a replica, failover with read-your-writes) under
the demand pager, the paged tensor store and the KV manager.

The transport and the cost model are the same Python in both packages,
so every ``PagingStats`` field, every ``PageInReceipt``, every
``WorkCompletion`` and the failover counters must be **equal**; the
payload rows of the port's ``DeviceFramePool(device="cpu")`` must equal
the reference's ``jnp`` rows.  The scenarios are those of
``tests/test_vmem.py::TestRemoteFramePool``,
``tests/test_chaos.py::TestRemotePagerFailover``,
``benchmarks/vmem_remote.py`` and ``examples/remote_paged_kv.py``, at the
4 KB page of the reference and at a 512 KB page (a Qwen3-14B KV page),
and the ``remote_paging`` phase of ``chip_smoke.py`` at small sizes.
"""

import dataclasses
import enum
import json

import numpy as np
import pytest
import torch

import repro.api as jax_api
import repro.vmem as jax_vmem
from repro.memory.kv_cache import PagedKVManager as JaxKVManager
from repro.memory.paged_store import PagedTensorStore as JaxStore

import repro_torch.api as t_api
import repro_torch.vmem as t_vmem
from repro_torch.memory.kv_cache import PagedKVManager
from repro_torch.memory.paged_store import PagedTensorStore

PAGE_SIZES = [4096, 524288]


class _Side:
    """One package's remote-paging vocabulary under common names."""

    def __init__(self, api, vmem, store, kv, device_kw):
        self.api, self.vmem, self.kv, self.device_kw = api, vmem, kv, device_kw
        self.store = store

    def pool(self, **kw):
        extra = {} if "local" in kw else self.device_kw
        return self.vmem.RemoteFramePool.build(**kw, **extra)

    def policy(self, strategy, **kw):
        return self.api.FaultPolicy(getattr(self.api.Strategy, strategy),
                                    **kw)


REF = _Side(jax_api, jax_vmem, JaxStore, JaxKVManager, {})
PORT = _Side(t_api, t_vmem, PagedTensorStore, PagedKVManager,
             {"device": "cpu"})


def canon(x):
    """Dataclasses as dicts and enums by class and member name, so the two
    packages' records compare field for field."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {f.name: canon(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    if isinstance(x, enum.Enum):
        return (type(x).__name__, x.name)
    if isinstance(x, (list, tuple)):
        return [canon(v) for v in x]
    if isinstance(x, dict):
        return {k: canon(v) for k, v in x.items()}
    if isinstance(x, torch.Tensor):
        return x.numpy()
    if type(x).__module__.startswith("jax"):
        return np.asarray(x)
    return x


def assert_same(ref, port, path="result"):
    if isinstance(ref, dict):
        assert isinstance(port, dict) and ref.keys() == port.keys(), path
        for k in ref:
            assert_same(ref[k], port[k], f"{path}.{k}")
    elif isinstance(ref, list):
        assert isinstance(port, list) and len(ref) == len(port), path
        for i, (a, b) in enumerate(zip(ref, port)):
            assert_same(a, b, f"{path}[{i}]")
    elif isinstance(ref, np.ndarray):
        assert isinstance(port, np.ndarray), path
        assert port.dtype == ref.dtype, path
        np.testing.assert_array_equal(port, ref, err_msg=path)
    else:
        assert port == ref, f"{path}: {port!r} != {ref!r}"


def twin(scenario, *args, **kw):
    """Run ``scenario(side, ...)`` on both packages; its observables must
    be equal.  Returns the port's (canonical) observables."""
    ref = canon(scenario(REF, *args, **kw))
    port = canon(scenario(PORT, *args, **kw))
    assert_same(ref, port)
    return port


def _drain(pool) -> list:
    return list(pool.cq.poll(max_entries=64)) + list(pool.completions)


def _failover_state(pool) -> dict:
    return dict(failed_over=pool.failed_over, failovers=pool.failovers,
                ryw_verified=pool.ryw_verified,
                ryw_violations=pool.ryw_violations)


# ----------------------------------------- tests/test_vmem.py twins
class TestRemoteFramePool:
    @staticmethod
    def _remote_pager(side, strategy=None, n_frames=4, n_pages=16):
        policy = side.policy(strategy) if strategy else None
        pool = side.pool(n_frames=n_frames, page_elems=8, n_pages=n_pages,
                         policy=policy)
        pager = side.vmem.Pager(pool, policy=policy or side.policy(
            "TOUCH_AHEAD", lookahead=4))
        sp = pager.create_space(n_pages, name="remote-tenant")
        for v in range(n_pages):
            sp.write(v, np.full(8, v, np.float32))
        return pool, pager, sp

    @staticmethod
    def _observe(pool, pager, sp, **extra):
        return dict(pager_stats=pager.stats, space_stats=sp.stats,
                    completions=_drain(pool), frames=pool.local.data,
                    failover=_failover_state(pool), **extra)

    def test_page_ins_complete_on_cq(self):
        def run(side):
            pool, pager, sp = self._remote_pager(side)
            out = sp.access([0])              # one block fault -> one read
            wcs = pool.cq.poll(max_entries=16)
            return self._observe(pool, pager, sp, out=out, polled=wcs)

        got = twin(run)
        assert len(got["polled"]) == 1
        assert got["polled"][0]["opcode"] == ("WROpcode", "READ")
        assert got["polled"][0]["nbytes"] == 4 * 4096
        assert got["pager_stats"]["remote_reads"] == 1
        assert got["pager_stats"]["remote_bytes_in"] == 4 * 4096

    def test_rapf_stats_surface_in_paging_stats(self):
        def run(side):
            pool, pager, sp = self._remote_pager(side)
            out = sp.access([0])
            return self._observe(pool, pager, sp, out=out)

        got = twin(run)
        assert got["pager_stats"]["remote_dst_faults"] > 0
        assert got["pager_stats"]["rapf_retransmits"] > 0
        assert got["space_stats"]["rapf_retransmits"] > 0
        assert got["pager_stats"]["simulated_us"] > 0

    def test_data_plane_still_real(self):
        def run(side):
            pool, pager, sp = self._remote_pager(side, "TOUCH_A_PAGE")
            out = sp.access([7])
            return self._observe(pool, pager, sp, out=out)

        got = twin(run)
        np.testing.assert_array_equal(got["out"][0], np.full(8, 7.0))
        assert got["pager_stats"]["remote_reads"] == 1

    def test_refault_after_eviction_posts_again(self):
        def run(side):
            pool, pager, sp = self._remote_pager(side, "TOUCH_A_PAGE",
                                                 n_frames=2)
            outs = [sp.access([v]) for v in (0, 1, 2, 0)]   # 0 evicted
            return self._observe(pool, pager, sp, outs=outs)

        got = twin(run)
        assert got["pager_stats"]["remote_reads"] == 4
        assert len(got["completions"]) == 4
        for out, v in zip(got["outs"], (0, 1, 2, 0)):
            np.testing.assert_array_equal(out[0], np.full(8, float(v)))


# --------------------------------------- tests/test_chaos.py twins
class TestRemotePagerFailover:
    @staticmethod
    def _pool(side, n_nodes=4, **kw):
        topo = {"topology": "ring"} if n_nodes > 2 else {}
        return side.pool(n_frames=8, page_elems=16, n_pages=32,
                         config=side.api.FabricConfig(n_nodes=n_nodes,
                                                      **topo), **kw)

    def test_failover_read_your_writes(self):
        def run(side):
            pool = self._pool(side, remote_node=1, replica_node=2)
            us = [pool.page_out(None, 0, 4)]
            r = [pool.page_in(None, 0, 2)]
            pool.fabric.crash_node(1)
            r.append(pool.page_in(None, 0, 4))
            state = _failover_state(pool)
            us.append(pool.page_out(None, 4, 2))
            r.append(pool.page_in(None, 4, 2))
            return dict(receipts=r, page_out_us=us, after_crash=state,
                        failover=_failover_state(pool),
                        completions=_drain(pool))

        got = twin(run)
        assert got["receipts"][0]["failovers"] == 0
        assert got["receipts"][1]["failovers"] == 1
        assert got["receipts"][1]["bytes_in"] == 4 * 4096
        assert got["after_crash"] == dict(failed_over=True, failovers=1,
                                          ryw_verified=4, ryw_violations=0)
        assert got["receipts"][2]["failovers"] == 1

    def test_failover_latency_spans_both_attempts(self):
        def run(side):
            pool = self._pool(side, remote_node=1, replica_node=2)
            r = [pool.page_in(None, 0, 1), pool.page_in(None, 0, 1)]
            pool.fabric.crash_node(1)
            r.append(pool.page_in(None, 0, 1))
            return dict(receipts=r, failover=_failover_state(pool),
                        completions=_drain(pool))

        got = twin(run)
        warm, recovery = got["receipts"][1], got["receipts"][2]
        assert recovery["failovers"] == 1
        assert recovery["us"] > warm["us"]

    def test_no_replica_means_failed_page_in(self):
        def run(side):
            pool = self._pool(side, n_nodes=2)
            pool.fabric.crash_node(1)
            return dict(receipt=pool.page_in(None, 0, 1),
                        failover=_failover_state(pool),
                        completions=_drain(pool))

        got = twin(run)
        assert got["receipt"]["failovers"] == 0
        assert got["receipt"]["bytes_in"] == 0
        assert got["completions"][0]["status"][1] != "SUCCESS"

    def test_replica_must_be_remote_from_primary(self):
        for side in (REF, PORT):
            with pytest.raises(ValueError, match="replica_node"):
                self._pool(side, remote_node=1, replica_node=1)


# ---------------- benchmarks/vmem_remote.py, examples/remote_paged_kv.py
def _kv_remote(side, strategy, page_bytes=4096):
    """``benchmarks/vmem_remote.py::_kv_remote`` (the scenario of
    ``examples/remote_paged_kv.py``): spill a sequence, fault its KV frames
    back in over the fabric."""
    pool = side.pool(n_frames=8, page_elems=0, n_pages=16,
                     page_bytes=page_bytes, local=side.vmem.FrameIdPool(8))
    kv = side.kv(n_frames=8, page_tokens=4, max_pages_per_seq=8,
                 policy=side.policy(strategy, lookahead=4), pool=pool)
    kv.add_sequence(1)
    kv.append_tokens(1, 32)                        # seq 1 fills the pool
    kv.add_sequence(2)
    kv.append_tokens(2, 16, spill_candidates=[1])  # spills 4 of seq 1
    n = kv.ensure_resident(1, spill_candidates=[2])
    return kv, pool, n


def _store_remote(side, strategy, page_bytes=4096, n_pages=32):
    """``benchmarks/vmem_remote.py::_store_remote``, payload kept."""
    pool = side.pool(n_frames=8, page_elems=64, n_pages=n_pages,
                     page_bytes=page_bytes)
    store = side.store(64, 8, n_pages, policy=side.policy(
        strategy, lookahead=4), pool=pool)
    for v in range(n_pages):
        store.write_host(v, [float(v)] * 64)
    outs = [store.access([v]) for v in range(n_pages)]
    return store, pool, outs


@pytest.mark.parametrize("page_bytes", PAGE_SIZES)
@pytest.mark.parametrize("strategy", ["TOUCH_A_PAGE", "TOUCH_AHEAD"])
def test_kv_fault_back_in_over_the_fabric(strategy, page_bytes):
    def run(side):
        kv, pool, n = _kv_remote(side, strategy, page_bytes)
        return dict(stats=kv.stats, n=n, completions=_drain(pool),
                    tables=kv.tables, spilled=kv.spilled,
                    device_table=kv.device_table([1, 2]))

    got = twin(run)
    s = got["stats"]
    assert got["n"] > 0 and s["remote_reads"] > 0
    assert len(got["completions"]) == s["remote_reads"]
    assert s["remote_bytes_in"] == got["n"] * page_bytes
    assert s["remote_dst_faults"] > 0 and s["rapf_retransmits"] > 0


@pytest.mark.parametrize("page_bytes", PAGE_SIZES)
@pytest.mark.parametrize("strategy", ["TOUCH_A_PAGE", "TOUCH_AHEAD",
                                      "STREAM"])
def test_store_streams_remote_pages(strategy, page_bytes):
    def run(side):
        store, pool, outs = _store_remote(side, strategy, page_bytes)
        return dict(stats=store.stats, outs=outs, frames=store.frames,
                    completions=_drain(pool))

    got = twin(run)
    for v, out in enumerate(got["outs"]):
        np.testing.assert_array_equal(out, np.full((1, 64), float(v),
                                                   np.float32))
    assert got["stats"]["rapf_retransmits"] > 0
    assert got["stats"]["remote_bytes_in"] % page_bytes == 0


def test_reference_twins_are_the_benchmarks_own_scenarios():
    """At the reference's page size the twins above are exactly
    ``benchmarks/vmem_remote.py``'s functions."""
    from benchmarks.vmem_remote import _kv_remote as bench_kv
    from benchmarks.vmem_remote import _store_remote as bench_store
    for strategy in ("TOUCH_A_PAGE", "TOUCH_AHEAD"):
        stats, pool, n = bench_kv(getattr(jax_api.Strategy, strategy))
        kv, pool2, n2 = _kv_remote(REF, strategy)
        assert (canon(stats), n) == (canon(kv.stats), n2)
        assert canon(_drain(pool)) == canon(_drain(pool2))
    for strategy in ("TOUCH_A_PAGE", "TOUCH_AHEAD", "STREAM"):
        stats, _ = bench_store(getattr(jax_api.Strategy, strategy))
        assert canon(stats) == canon(_store_remote(REF, strategy)[0].stats)


@pytest.mark.parametrize("page_bytes", PAGE_SIZES)
def test_example_prints_the_same_lines(page_bytes):
    """``examples/remote_paged_kv.py``'s report, line for line."""
    def run(side):
        lines = []
        for strategy in ("TOUCH_A_PAGE", "TOUCH_AHEAD"):
            kv, pool, n = _kv_remote(side, strategy, page_bytes)
            s = kv.stats
            wcs = pool.cq.poll(max_entries=64) + pool.completions
            lines += [
                f"{strategy.lower():14s}: {n} KV pages faulted back in "
                f"over the fabric in {s.remote_reads} verbs read(s)",
                f"completions on CQ: "
                f"{[f'{wc.nbytes}B @ {wc.latency_us:.1f}us' for wc in wcs]}",
                f"dst_faults={s.remote_dst_faults} "
                f"rapf_retransmits={s.rapf_retransmits} "
                f"simulated fault time={s.simulated_us:.1f}us"]
        return lines

    lines = twin(run)
    assert len(lines) == 6


# ------------------------------------------------------- the device rule
class TestDeviceRule:
    def test_payload_pool_without_device_needs_a_gpu(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA"):
            t_vmem.RemoteFramePool.build(n_frames=4, page_elems=8,
                                         n_pages=8)

    def test_control_plane_pool_needs_no_device(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        pool = t_vmem.RemoteFramePool.build(
            n_frames=4, page_elems=0, n_pages=8,
            local=t_vmem.FrameIdPool(4))
        assert pool.data is None and pool.page_in(None, 0, 2).bytes_in \
            == 2 * 4096

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_dtype_and_device_place_the_local_pool(self, dtype):
        pool = t_vmem.RemoteFramePool.build(n_frames=4, page_elems=8,
                                            n_pages=8, dtype=dtype,
                                            device="cpu")
        assert isinstance(pool.local, t_vmem.DeviceFramePool)
        assert pool.data.device.type == "cpu"
        assert pool.data.dtype == getattr(torch, dtype)
        pool.load(2, np.arange(8, dtype=np.float32))
        assert pool.gather(np.array([2])).float().tolist() == \
            [list(map(float, range(8)))]


# --------------------------------------- chip_smoke.py's remote_paging phase
def test_chip_phase_runs_on_the_cpu_at_reduced_width(capsys):
    import chip_smoke
    table = [{"name": "page_gather"}, {"name": "page_scatter"}]
    chip_smoke.phase_remote_paging(torch.device("cpu"),
                                   chip_smoke.Sizes(full_width=False), table)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["phase"] == "remote_paging"
    for name, st in line["strategies"].items():
        cold = st["passes"][0]
        assert cold["remote_dst_faults"] > 0 and cold["rapf_retransmits"] > 0
        assert all(p["rows_exact"] for p in st["passes"])
    fo = line["failover"]
    assert fo["failovers"] > 0 and fo["ryw_violations"] == 0
    assert all(r["launches_by_path"] == {"remote_paging": 0} for r in table)


def test_chip_run_at_a_qwen3_kv_page():
    """The phase's scenario at its real page size, a few pages a sequence
    (a pool of at least twice the lookahead, as the phase's: see
    ``test_read_ahead_past_the_pool_is_held_equal``)."""
    import chip_smoke
    res = chip_smoke.remote_paging_run(torch.device("cpu"), 524288,
                                       seq_pages=8, pool_frames=8)
    assert res["page_bytes"] == 524288
    assert res["page_elems"] * np.dtype(
        np.float32 if res["dtype"] == "float32" else np.float16).itemsize \
        == 524288
    for st in res["strategies"].values():
        assert st["passes"][0]["remote_dst_faults"] >= 8 * 128 - 3
        assert st["passes"][2]["remote_reads"] > 0
    assert res["failover"]["ryw_verified"] > 0


@pytest.mark.parametrize("strategy,n_frames", [("TOUCH_AHEAD", 3),
                                               ("STREAM", 4)])
def test_read_ahead_past_the_pool_is_held_equal(strategy, n_frames):
    """A fault block (lookahead 4) or a STREAM warm-up (the next block)
    that needs more frames than the pool has evicts the demanded page
    while it is brought in: the reference's pager then returns another
    page's row for it and leaves it unmapped.  The port reproduces that,
    as the reference is the contract (ROADMAP, queue C); the chip phase's
    pool holds a whole sequence, far above twice the lookahead."""
    def run(side):
        pool = side.pool(n_frames=n_frames, page_elems=4, n_pages=8)
        store = side.store(4, n_frames, 8, policy=side.policy(
            strategy, lookahead=4), pool=pool)
        for v in range(8):
            store.write_host(v, np.full(4, v, np.float32))
        return dict(out=store.access([0]), table=store.page_table,
                    stats=store.stats, completions=_drain(pool))

    got = twin(run)
    assert got["table"][0] == -1                 # the demanded page
    assert got["out"][0][0] != 0.0               # another page's row
