"""Port vs reference, demand pager and KV manager: the access traces of
``tests/test_vmem.py`` (those that need no fabric) and the
``TestPagedKVManager`` cases of ``tests/test_runtime.py``, replayed on both
packages.  The cost-model accounting is pure Python in both, so the
``PagingStats`` dicts must be **equal**, and payloads equal; the port's
``DeviceFramePool`` runs with ``device="cpu"`` here.
"""

import dataclasses
import warnings

import numpy as np
import pytest
import torch

import repro.api as jax_api
import repro.vmem as jax_vmem
from repro.memory.kv_cache import PagedKVManager as JaxKVManager
from repro.memory.paged_store import PagedTensorStore as JaxStore

import repro_torch.api as t_api
import repro_torch.vmem as t_vmem
from repro_torch.memory import paged_store as t_paged_store
from repro_torch.memory.kv_cache import PagedKVManager
from repro_torch.memory.paged_store import PagedTensorStore


class _Side:
    """One package's pager vocabulary under common names."""

    def __init__(self, api, vmem, kv, store, device_kw):
        self.api, self.vmem, self.kv, self.device_kw = api, vmem, kv, device_kw
        self._store = store

    def store(self, *args, **kw):
        return self._store(*args, **kw, **self.device_kw)

    def device_pool(self, n, e, **kw):
        return self.vmem.DeviceFramePool(n, e, **kw, **self.device_kw)

    def policy(self, strategy, **kw):
        return self.api.FaultPolicy(getattr(self.api.Strategy, strategy), **kw)

    def pager(self, n_frames=4, n_pages=16, page_elems=8, strategy=None,
              lookahead=None, eviction=None, pool=None, **pol_kw):
        pool = pool or self.device_pool(n_frames, page_elems)
        kw = {}
        if strategy:
            if lookahead is not None:
                pol_kw["lookahead"] = lookahead
            kw["policy"] = self.policy(strategy, **pol_kw)
        if eviction:
            kw["eviction"] = getattr(self.vmem, eviction)()
        pager = self.vmem.Pager(pool, **kw)
        space = pager.create_space(n_pages, name="t0")
        for v in range(n_pages):
            space.write(v, np.full(page_elems, v, np.float32))
        return pager, space


SIDES = (_Side(jax_api, jax_vmem, JaxKVManager, JaxStore, {}),
         _Side(t_api, t_vmem, PagedKVManager, PagedTensorStore,
               {"device": "cpu"}))


def _arr(x):
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.asarray(x)


def _replay(trace):
    """Run ``trace(side)`` on both packages; it returns (stats objects,
    payload arrays).  Stats must be equal field by field, payloads equal."""
    (js, jp), (ts, tp) = (trace(s) for s in SIDES)
    assert len(js) == len(ts) and len(jp) == len(tp)
    for a, b in zip(js, ts):
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
    for a, b in zip(jp, tp):
        a, b = _arr(a), _arr(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    return ts, tp


class TestPagerCore:
    def test_fault_resolve_map_roundtrip(self):
        def trace(s):
            pager, sp = s.pager(strategy="TOUCH_A_PAGE")
            out = sp.access([3])
            assert sp.is_resident(3)
            return [pager.stats, sp.stats], [out, sp.page_table]
        (stats, _), (out, _) = _replay(trace)
        np.testing.assert_array_equal(_arr(out)[0], np.full(8, 3.0))
        assert stats.faults == 1 and stats.pages_in == 1
        assert stats.simulated_us > 0

    def test_touch_ahead_prefetch_and_hits(self):
        def trace(s):
            pager, sp = s.pager(strategy="TOUCH_AHEAD", lookahead=4)
            a = sp.access([0])
            assert sp.resident_pages() == 4
            b = sp.access([1, 2, 3])
            return [pager.stats, sp.stats], [a, b, sp.page_table,
                                             sp.prefetched]
        (stats, _), _ = _replay(trace)
        assert stats.faults == 1 and stats.prefetch_hits == 3

    def test_stream_predictor_warms_next_block(self):
        def trace(s):
            pager, sp = s.pager(n_frames=8, strategy="STREAM", lookahead=4)
            out = sp.access([0])
            assert sp.resident_pages() == 5 and sp.is_resident(4)
            return [pager.stats], [out, sp.page_table]
        _replay(trace)

    def test_host_pool_backend(self):
        def trace(s):
            pager = s.vmem.Pager(s.vmem.HostFramePool(4, 8))
            sp = pager.create_space(8)
            sp.write(5, np.arange(8))
            return [pager.stats], [sp.access([5])]
        _, (out,) = _replay(trace)
        np.testing.assert_array_equal(_arr(out)[0], np.arange(8.0))

    def test_writeback_on_eviction(self):
        def trace(s):
            pager, sp = s.pager(n_frames=2, strategy="TOUCH_A_PAGE")
            sp.access([0])
            f = int(sp.page_table[0])
            pager.pool.load(f, np.full(8, 99.0))
            sp.access([1])
            sp.access([2])                        # evicts page 0 (LRU)
            assert not sp.is_resident(0)
            return [pager.stats], [sp.backing, sp.access([0])]
        _, (backing, again) = _replay(trace)
        np.testing.assert_array_equal(backing[0], np.full(8, 99.0))
        np.testing.assert_array_equal(_arr(again)[0], np.full(8, 99.0))

    @pytest.mark.parametrize("dtype,want", [(np.float64, np.float32),
                                            (np.int64, np.int32),
                                            (np.float32, np.float32),
                                            (np.int32, np.int32)])
    def test_payload_dtype_canonicalized(self, dtype, want):
        """64-bit payload types narrow to 32 bits on both sides."""
        def trace(s):
            pager = s.vmem.Pager(s.device_pool(2, 4, dtype=dtype))
            sp = pager.create_space(4)
            sp.write(1, np.arange(4))
            host = s.vmem.HostFramePool(2, 4, dtype=dtype)
            assert host.data.dtype == want and sp.backing.dtype == want
            return [pager.stats], [sp.access([1]), pager.pool.store(0)]
        _replay(trace)


class TestEvictionUnderPins:
    def test_pinned_pages_never_evicted(self):
        def trace(s):
            pager, sp = s.pager(n_frames=4, strategy="TOUCH_A_PAGE")
            sp.pin([0, 1])
            outs = [sp.access([v]) for v in (2, 3, 4, 5, 6)]
            assert sp.is_resident(0) and sp.is_resident(1)
            return [pager.stats, sp.stats], outs + [sp.page_table, sp.pinned]
        (stats, _), _ = _replay(trace)
        assert stats.evictions == 3

    def test_all_pinned_raises_with_violation(self):
        def trace(s):
            pager, sp = s.pager(n_frames=2, strategy="TOUCH_A_PAGE")
            sp.pin([0, 1])
            with pytest.raises(MemoryError):
                sp.access([2])
            return [pager.stats, sp.stats], []
        (stats, sstats), _ = _replay(trace)
        assert stats.pin_violations == 1 and sstats.pin_violations == 1

    def test_fault_policy_pin_budget(self):
        def trace(s):
            pager, sp = s.pager(n_frames=4, strategy="TOUCH_A_PAGE",
                                pin_limit_bytes=2 * 4096)
            sp.pin([0, 1])                        # exactly the budget
            with pytest.raises(MemoryError):
                sp.pin([2])
            sp.unpin([0])
            return [pager.stats], [sp.pinned]
        (stats,), _ = _replay(trace)
        assert stats.pin_violations == 1

    def test_clock_eviction_second_chance(self):
        def trace(s):
            pager, sp = s.pager(n_frames=2, eviction="ClockEviction",
                                strategy="TOUCH_A_PAGE")
            for v in (0, 1, 0, 2):
                sp.access([v])
            assert sp.resident_pages() == 2
            return [pager.stats], [sp.page_table]
        (stats,), _ = _replay(trace)
        assert stats.evictions == 1


class TestMultiTenantSharedPool:
    def test_two_spaces_one_pool_contention(self):
        def trace(s):
            pager = s.vmem.Pager(s.device_pool(8, 4),
                                 policy=s.policy("TOUCH_A_PAGE"),
                                 eviction=s.vmem.PinAwareLRU())
            a = pager.create_space(16, name="a")
            b = pager.create_space(16, name="b")
            for v in range(8):
                a.access([v])
            for v in range(2):
                b.access([v])
            assert a.resident_pages() == 6 and b.resident_pages() == 2
            return [pager.stats, a.stats, b.stats], [a.page_table,
                                                     b.page_table]
        (stats, a, b), _ = _replay(trace)
        assert stats.spills == 2 and b.spills == 2 and a.pages_out == 2

    def test_pinning_tenant_cannot_be_robbed(self):
        def trace(s):
            pager = s.vmem.Pager(s.device_pool(4, 4),
                                 policy=s.policy("TOUCH_A_PAGE"),
                                 eviction=s.vmem.PinAwareLRU())
            a = pager.create_space(8, name="a")
            b = pager.create_space(8, name="b")
            a.pin([0, 1, 2])
            b.access([0])
            b.access([1])
            assert a.resident_pages() == 3 and b.resident_pages() == 1
            pager.pin(b, [1])
            with pytest.raises(MemoryError):
                b.access([2])
            return [pager.stats, a.stats, b.stats], []
        (stats, _, _), _ = _replay(trace)
        assert stats.pin_violations == 1

    def test_per_space_policy_override(self):
        def trace(s):
            pager = s.vmem.Pager(s.device_pool(8, 4),
                                 policy=s.policy("TOUCH_AHEAD", lookahead=4))
            a = pager.create_space(16, name="a")
            b = pager.create_space(16, name="b",
                                   policy=s.policy("TOUCH_A_PAGE"))
            a.access([0])
            b.access([0])
            assert a.resident_pages() == 4 and b.resident_pages() == 1
            return [pager.stats, a.stats, b.stats], []
        _replay(trace)

    def test_shared_pool_across_separate_pagers(self):
        def trace(s):
            pool = s.device_pool(4, 16)
            pa = s.vmem.Pager(pool, policy=s.policy("TOUCH_A_PAGE"))
            pb = s.vmem.Pager(pool, policy=s.policy("TOUCH_A_PAGE"))
            a, b = pa.create_space(8), pb.create_space(8)
            b.access([0, 1, 2, 3])                # b fills the shared pool
            a.access([0])                         # must evict one of b's
            assert a.resident_pages() == 1 and b.resident_pages() == 3
            return [pa.stats, pb.stats, a.stats, b.stats], []
        (pa, _, _, _), _ = _replay(trace)
        assert pa.spills == 1

    def test_frame_id_pool_is_control_plane_only(self):
        def trace(s):
            pager = s.vmem.Pager(s.vmem.FrameIdPool(4))
            sp = pager.create_space(8)
            assert sp.backing is None
            pager.map_fresh(sp, 0)
            assert sp.is_resident(0)
            with pytest.raises(NotImplementedError):
                sp.access([0])
            return [pager.stats], [sp.page_table]
        _replay(trace)

    def test_random_access_trace(self):
        """A longer seeded trace over two tenants with different policies:
        reads, pins, unpins and writes, stats and payloads equal."""
        def trace(s):
            rng = np.random.default_rng(11)
            pager = s.vmem.Pager(s.device_pool(8, 8),
                                 policy=s.policy("TOUCH_AHEAD", lookahead=2),
                                 eviction=s.vmem.PinAwareLRU())
            a = pager.create_space(24, name="a")
            b = pager.create_space(24, name="b",
                                   policy=s.policy("STREAM", lookahead=2))
            for sp in (a, b):
                for v in range(24):
                    sp.write(v, rng.standard_normal(8))
            outs = []
            for step in range(60):
                sp = (a, b)[int(rng.integers(2))]
                v = int(rng.integers(24))
                op = int(rng.integers(10))
                if op == 0 and sp.pinned.sum() < 1:
                    sp.pin([v])
                elif op == 1:
                    sp.unpin(np.where(sp.pinned)[0])
                elif op == 2:
                    sp.write(v, rng.standard_normal(8))
                else:
                    outs.append(sp.access([v]))
                    # a page evicted again within its own access would be
                    # gathered through a -1 entry (see the test below)
                    assert sp.is_resident(v)
            return [pager.stats, a.stats, b.stats], outs + [a.page_table,
                                                            b.page_table]
        (stats, _, _), _ = _replay(trace)
        assert stats.evictions > 0 and stats.faults > 0


class TestKnownDivergence:
    """Behaviour that once differed between the packages, held to parity."""

    def test_gather_of_unmapped_frame(self):
        """``DeviceFramePool.gather`` of a -1 (non-resident) frame id: both
        packages count it from the end, as ``jnp.take`` does, and return
        the pool's LAST row (the port's ``page_gather`` kernel itself keeps
        the Pallas kernel's clamp to row 0; the pool wraps the id first)."""
        rows = np.arange(12, dtype=np.float32).reshape(4, 3)
        outs = []
        for s in SIDES:
            pool = s.device_pool(4, 3)
            for f in range(4):
                pool.load(f, rows[f])
            outs.append(_arr(pool.gather(np.array([2, -1]))))
        np.testing.assert_array_equal(outs[0], outs[1])
        np.testing.assert_array_equal(outs[1][1], rows[3])


class TestUnifiedStatsAndPolicy:
    def test_stats_fields_and_aliases_match(self):
        j, t = jax_vmem.PagingStats(), t_vmem.PagingStats()
        assert dataclasses.asdict(j) == dataclasses.asdict(t)
        s = t_vmem.PagingStats(faults=3, pages_in=9, simulated_us=2.0)
        assert s.fault_events == 3 and s.fault_page_ins == 9
        s.merge(t_vmem.PagingStats(faults=2, simulated_us=0.5))
        assert s.faults == 5 and s.simulated_us == 2.5
        s.reset()
        assert s == t_vmem.PagingStats()

    def test_policy_defaults_match(self):
        j, t = jax_api.FaultPolicy(), t_api.FaultPolicy()
        assert j.strategy.value == t.strategy.value
        assert j.lookahead == t.lookahead
        assert [s.value for s in jax_api.Strategy] == \
            [s.value for s in t_api.Strategy]

    def test_legacy_kwargs(self):
        with pytest.warns(DeprecationWarning, match="deprecated"):
            pol = t_vmem.coerce_policy("X", None,
                                       t_api.Strategy.TOUCH_A_PAGE, 2)
        assert pol.strategy is t_api.Strategy.TOUCH_A_PAGE
        assert pol.lookahead == 2
        pol = t_api.FaultPolicy(t_api.Strategy.STREAM)
        assert t_vmem.coerce_policy("X", pol) is pol
        with pytest.raises(TypeError):
            t_vmem.coerce_policy("X", pol, t_api.Strategy.TOUCH_A_PAGE)
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            assert t_vmem.coerce_policy("X", None).strategy \
                is t_api.Strategy.TOUCH_AHEAD

    def test_predictors_match_policies(self):
        assert isinstance(t_vmem.predictor_for(
            t_api.FaultPolicy(t_api.Strategy.STREAM)), t_vmem.StreamPrefetch)
        assert isinstance(t_vmem.predictor_for(
            t_api.FaultPolicy(t_api.Strategy.KERNEL_RAPF)),
            t_vmem.TouchAheadPrefetch)

    def test_device_pool_defaults_to_the_gpu(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present")
        with pytest.raises(RuntimeError, match="CUDA"):
            t_vmem.DeviceFramePool(4, 8)


class TestPagedKVManager:
    @staticmethod
    def _kv(s, *args, strategy=None, **kw):
        if strategy:
            kw["strategy"] = getattr(s.api.Strategy, strategy)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            return s.kv(*args, **kw)

    def test_spill_and_touch_ahead_fault(self):
        def trace(s):
            kv = self._kv(s, n_frames=8, page_tokens=4, max_pages_per_seq=8,
                          strategy="TOUCH_AHEAD")
            kv.add_sequence(1)
            kv.add_sequence(2)
            kv.append_tokens(1, 32)
            assert kv.frames_used == 8
            kv.append_tokens(2, 8, spill_candidates=[1])
            assert kv.stats.spills == 2 and len(kv.spilled[1]) == 2
            n = kv.ensure_resident(1, spill_candidates=[2])
            assert n == 2 and not kv.spilled[1]
            return [kv.stats], [kv.device_table([1, 2]),
                                kv.batch_lengths([1, 2])]
        (stats,), _ = _replay(trace)
        assert stats.fault_events == 1

    def test_touch_a_page_pays_per_page(self):
        def trace(s):
            kv = self._kv(s, 8, 4, 8, strategy="TOUCH_A_PAGE")
            kv.add_sequence(1)
            kv.add_sequence(2)
            kv.append_tokens(1, 32)
            kv.append_tokens(2, 12, spill_candidates=[1])
            assert kv.ensure_resident(1, spill_candidates=[2]) == 3
            return [kv.stats], [kv.device_table([1, 2])]
        (stats,), _ = _replay(trace)
        assert stats.fault_events == 3

    def test_device_table_masks_spilled(self):
        def trace(s):
            kv = self._kv(s, 4, 4, 4)
            kv.add_sequence(1)
            kv.append_tokens(1, 16)
            assert (kv.device_table([1]) >= 0).all()
            kv.add_sequence(2)
            kv.append_tokens(2, 4, spill_candidates=[1])
            tbl = kv.device_table([1])
            assert (tbl == -1).sum() == 1
            kv.free_sequence(2)
            return [kv.stats], [tbl, np.asarray(sorted(kv.free))]
        _replay(trace)

    def test_churn_trace(self):
        """Sequences come, grow, get re-activated and go; every table and
        the stats stay equal."""
        def trace(s):
            rng = np.random.default_rng(5)
            kv = s.kv(6, 4, 4, policy=s.policy("TOUCH_AHEAD", lookahead=2))
            tables, live = [], []
            for seq in range(1, 9):
                kv.add_sequence(seq)
                kv.append_tokens(seq, int(rng.integers(1, 9)))
                live.append(seq)
                for other in live:
                    kv.ensure_resident(other)
                    kv.append_tokens(other, 1)
                tables.append(kv.device_table(live))
                if len(live) > 2:
                    kv.free_sequence(live.pop(0))
            return [kv.stats], tables
        (stats,), _ = _replay(trace)
        assert stats.spills > 0 and stats.pages_in > 0


def _set_frame(st, f, value):
    """Overwrite frame ``f`` of a store: in place in the port, through the
    reference's ``frames`` setter there."""
    if isinstance(st.frames, torch.Tensor):
        st.frames[f] = torch.full((st.page_elems,), value,
                                  dtype=st.frames.dtype)
    else:
        st.frames = st.frames.at[f].set(value)


class TestPagedTensorStore:
    """Twin of ``tests/test_runtime.py::TestPagedTensorStore``: the same
    traces on both packages' ``PagedTensorStore``; stats equal field by
    field, page tables and payloads equal."""

    def test_fault_and_touch_ahead(self):
        def trace(s):
            st = s.store(page_elems=8, n_device_frames=4, n_host_pages=16,
                         strategy=s.api.Strategy.TOUCH_AHEAD, lookahead=4)
            for v in range(16):
                st.write_host(v, np.full(8, v, np.float32))
            out = st.access([0])
            assert st.stats.faults == 1 and st.resident_pages() == 4
            more = st.access([1, 2, 3])
            return [st.stats], [out, more, st.page_table, st.prefetched]
        (stats,), (out, more, _, _) = _replay(trace)
        np.testing.assert_array_equal(out[0], np.zeros(8))
        np.testing.assert_array_equal(more[:, 0], [1.0, 2.0, 3.0])
        assert stats.faults == 1 and stats.prefetch_hits == 3

    def test_touch_a_page_faults_per_page(self):
        def trace(s):
            st = s.store(8, 8, 16, strategy=s.api.Strategy.TOUCH_A_PAGE)
            for v in range(16):
                st.write_host(v, np.full(8, v, np.float32))
            out = st.access([0, 1, 2, 3])
            return [st.stats], [out, st.page_table]
        (stats,), _ = _replay(trace)
        assert stats.faults == 4

    def test_eviction_writeback_roundtrip(self):
        """The device copy is changed (in place in the port), evicted with
        writeback and faulted back in."""
        def trace(s):
            st = s.store(4, 2, 8, strategy=s.api.Strategy.TOUCH_A_PAGE)
            st.write_host(0, np.zeros(4, np.float32))
            st.access([0])
            _set_frame(st, int(st.page_table[0]), 7.0)
            st.access([1])
            st.access([2])                        # evicts page 0 (LRU)
            assert not st.is_resident(0)
            return [st.stats], [st.host, st.access([0]), st.page_table,
                                np.asarray(sorted(st.free_frames))]
        _, (host, again, _, _) = _replay(trace)
        np.testing.assert_array_equal(host[0], np.full(4, 7.0))
        np.testing.assert_array_equal(again[0], np.full(4, 7.0))

    def test_pinned_never_evicted(self):
        def trace(s):
            st = s.store(4, 2, 8)
            st.pin([0])
            st.access([1])
            st.pin([1])
            with pytest.raises(MemoryError):
                st.access([2])
            return [st.stats], [st.page_table, st.pinned]
        _replay(trace)

    def test_seeded_random_trace(self):
        """Accesses, pins, writebacks and frame edits drawn from one seed
        over a three-frame pool (Touch-Ahead, lookahead 2)."""
        def trace(s):
            rng = np.random.default_rng(11)
            st = s.store(6, 3, 12, strategy=s.api.Strategy.TOUCH_AHEAD,
                         lookahead=2)
            for v in range(12):
                st.write_host(v, rng.standard_normal(6).astype(np.float32))
            outs = []
            for _ in range(40):
                op = rng.integers(0, 10)
                v = int(rng.integers(0, 12))
                if op < 6:
                    outs.append(st.access([v, (v + 1) % 12]))
                elif op == 6 and st.is_resident(v):
                    _set_frame(st, int(st.page_table[v]), float(v) + 0.5)
                elif op == 7 and st.is_resident(v):
                    st.write_back(v)
                elif op == 8 and st.is_resident(v) and not st.pinned.any():
                    st.pin([v])
                elif op == 9:
                    st.unpin(np.flatnonzero(st.pinned).tolist())
                st.ensure_resident([v])
                outs.append(st.frame_ids([v]))
            return [st.stats], outs + [st.host, st.page_table, st.frames]
        (stats,), _ = _replay(trace)
        assert stats.faults > 0 and stats.evictions > 0

    def test_shared_pool_and_injected_pager(self):
        """Two stores on one pool contend for its frames; a store given a
        pager follows that pager's policy."""
        def trace(s):
            pool = s.device_pool(3, 4)
            a = s.store(4, 0, 6, pool=pool,
                        strategy=s.api.Strategy.TOUCH_A_PAGE)
            b = s.store(4, 0, 6, pool=pool,
                        strategy=s.api.Strategy.TOUCH_AHEAD, lookahead=2)
            for v in range(6):
                a.write_host(v, np.full(4, v, np.float32))
                b.write_host(v, np.full(4, 10 + v, np.float32))
            outs = [a.access([0, 1]), b.access([3]), a.access([0])]
            pager = s.vmem.Pager(s.device_pool(4, 4),
                                 policy=s.policy("TOUCH_AHEAD", lookahead=3))
            c = s.store(4, 0, 8, pager=pager)
            assert c.lookahead == 3 and c.pager is pager
            outs.append(c.access([2]))
            return [a.stats, b.stats, c.stats], outs + [a.page_table,
                                                        b.page_table]
        _replay(trace)

    def test_store_stats_alias_and_default_device(self):
        assert t_paged_store.StoreStats is t_vmem.PagingStats
        if torch.cuda.is_available():
            assert PagedTensorStore(4, 2, 8).frames.is_cuda
            return
        with pytest.raises(RuntimeError, match="CUDA"):
            PagedTensorStore(4, 2, 8)
