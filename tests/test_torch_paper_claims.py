"""Port vs reference, the thesis' headline claims: the twin of
``tests/test_paper_claims.py`` (DESIGN.md §1, C1–C9).

Every assertion of the reference's test, over the port's copies
``repro_torch.core.{experiments,firehose,costmodel,engine,resolver}``.
Then, for every ``run_remote_write`` case those assertions use and every
Firehose working-set size, the port's result equals the reference's
exactly: ``latency_us``, ``prep_us`` and every field of ``stats``, and
every put latency of the Firehose run.
"""

import dataclasses

import pytest

from repro_torch.core.costmodel import DEFAULT_COST_MODEL
from repro_torch.core.engine import BufferPrep
from repro_torch.core.experiments import run_remote_write
from repro_torch.core.firehose import FirehoseConfig, FirehoseNode
from repro_torch.core.resolver import Strategy


def _dst_ratio(size):
    tap = run_remote_write(size, BufferPrep.TOUCHED, BufferPrep.FAULTING,
                           strategy=Strategy.TOUCH_A_PAGE)
    ta = run_remote_write(size, BufferPrep.TOUCHED, BufferPrep.FAULTING,
                          strategy=Strategy.TOUCH_AHEAD)
    return tap.latency_us / ta.latency_us


def _src_ratio(size):
    tap = run_remote_write(size, BufferPrep.FAULTING, BufferPrep.TOUCHED,
                           strategy=Strategy.TOUCH_A_PAGE)
    ta = run_remote_write(size, BufferPrep.FAULTING, BufferPrep.TOUCHED,
                          strategy=Strategy.TOUCH_AHEAD)
    return tap.latency_us / ta.latency_us


class TestC1IdealLatency:
    def test_16b_rtt_is_4us(self):
        r = run_remote_write(16, BufferPrep.TOUCHED, BufferPrep.TOUCHED)
        assert r.latency_us == pytest.approx(4.0, abs=0.25)
        assert r.stats.timeouts == 0
        assert r.stats.dst_faults == 0 and r.stats.src_faults == 0

    def test_latency_monotone_in_size(self):
        lats = [run_remote_write(s, BufferPrep.TOUCHED, BufferPrep.TOUCHED
                                 ).latency_us
                for s in (16, 1024, 4096, 16384, 65536)]
        assert lats == sorted(lats)


class TestC2OsCosts:
    """Table 4.1 is the calibration table — reproduced exactly."""

    def test_table_4_1_exact(self):
        from repro_torch.core.costmodel import TABLE_4_1, TABLE_4_1_SIZES
        c = DEFAULT_COST_MODEL
        for i, size in enumerate(TABLE_4_1_SIZES):
            assert c.mmap_us(size) == pytest.approx(TABLE_4_1["mmap"][i])
            assert c.pin_us(size) == pytest.approx(TABLE_4_1["pin"][i])
            assert c.unpin_us(size) == pytest.approx(TABLE_4_1["unpin"][i])
            assert c.touch_us(size) == pytest.approx(TABLE_4_1["touch"][i])
            assert c.munmap_us(size) == pytest.approx(TABLE_4_1["munmap"][i])

    def test_pin_unpin_grow_with_pages(self):
        c = DEFAULT_COST_MODEL
        assert c.pin_us(65536) > c.pin_us(16384) > c.pin_us(4096)
        assert c.touch_us(65536) > c.touch_us(4096)


class TestC3DestinationFaults:
    """Touch-Ahead/Touch-A-Page benefit 1.7x/1.2x/1.2x at 16/32/64 KB."""

    def test_16kb_ratio(self):
        assert _dst_ratio(16384) == pytest.approx(1.7, abs=0.15)

    def test_interleaving_dampens_benefit(self):
        # paper: benefit decreases at 32/64 KB due to FIFO duplicates
        r16, r32, r64 = _dst_ratio(16384), _dst_ratio(32768), _dst_ratio(65536)
        assert r32 < r16
        assert r64 == pytest.approx(1.2, abs=0.15)

    def test_sub_page_sizes_equal(self):
        # "the results seem similar up to 4KB, which is the size of one page"
        for s in (16, 256, 4096):
            tap = run_remote_write(s, BufferPrep.TOUCHED, BufferPrep.FAULTING,
                                   strategy=Strategy.TOUCH_A_PAGE)
            ta = run_remote_write(s, BufferPrep.TOUCHED, BufferPrep.FAULTING,
                                  strategy=Strategy.TOUCH_AHEAD)
            assert tap.latency_us / ta.latency_us == pytest.approx(1.0, abs=0.25)


class TestC4C5SourceFaults:
    def test_source_ratios(self):
        # paper: 3.9x / 3.9x / 4.7x — one timeout per *page* vs per *block*
        assert _src_ratio(16384) == pytest.approx(3.9, abs=0.3)
        assert _src_ratio(32768) == pytest.approx(3.9, abs=0.3)
        assert _src_ratio(65536) == pytest.approx(4.3, abs=0.6)

    def test_timeout_counts(self):
        tap = run_remote_write(16384, BufferPrep.FAULTING, BufferPrep.TOUCHED,
                               strategy=Strategy.TOUCH_A_PAGE)
        ta = run_remote_write(16384, BufferPrep.FAULTING, BufferPrep.TOUCHED,
                              strategy=Strategy.TOUCH_AHEAD)
        assert tap.stats.timeouts == 4   # one per 4 KB page
        assert ta.stats.timeouts == 1    # one per 16 KB block

    def test_small_transfers_dominated_by_timeout(self):
        r = run_remote_write(16, BufferPrep.FAULTING, BufferPrep.TOUCHED,
                             strategy=Strategy.TOUCH_A_PAGE)
        assert r.stats.timeouts == 1
        assert r.latency_us == pytest.approx(
            DEFAULT_COST_MODEL.timeout_us, rel=0.15)


class TestC6SrcPlusDstFasterThanSrc:
    @pytest.mark.parametrize("size", [16384, 65536])
    def test_fewer_timeouts_and_lower_latency(self, size):
        src = run_remote_write(size, BufferPrep.FAULTING, BufferPrep.TOUCHED,
                               strategy=Strategy.TOUCH_A_PAGE)
        both = run_remote_write(size, BufferPrep.FAULTING, BufferPrep.FAULTING,
                                strategy=Strategy.TOUCH_A_PAGE)
        assert both.stats.timeouts < src.stats.timeouts
        assert both.latency_us < src.latency_us
        # dst NACKs turned into explicit RAPF retransmissions
        assert both.stats.rapf_retransmits > 0


class TestC7TimeoutSweep:
    def test_1ms_best(self):
        lats = {to: run_remote_write(16384, BufferPrep.FAULTING,
                                     BufferPrep.TOUCHED,
                                     strategy=Strategy.TOUCH_A_PAGE,
                                     timeout_us=to).latency_us
                for to in (25000.0, 2500.0, 1000.0)}
        assert lats[1000.0] < lats[2500.0] < lats[25000.0]


class TestC8DriverLatency:
    def test_gup_costs_more_in_kernel(self):
        tap = run_remote_write(16384, BufferPrep.TOUCHED, BufferPrep.FAULTING,
                               strategy=Strategy.TOUCH_A_PAGE)
        ta = run_remote_write(16384, BufferPrep.TOUCHED, BufferPrep.FAULTING,
                              strategy=Strategy.TOUCH_AHEAD)
        assert ta.stats.driver_us > tap.stats.driver_us
        # but Touch-Ahead does all the paging in kernel -> less user time
        assert ta.stats.user_us < tap.stats.user_us
        # and both are microsecond-scale (not ms)
        assert tap.stats.driver_us < 100 and ta.stats.driver_us < 100


class TestC9FirehoseCliff:
    def test_latency_jumps_past_pinnable_memory(self):
        cfg = FirehoseConfig(M_bytes=4 << 20, maxvictim_bytes=1 << 20,
                             n_nodes=2)
        node = FirehoseNode(cfg)
        buckets_in_m = cfg.M_bytes // cfg.bucket_bytes

        def avg_put(working_set_buckets, rounds=3):
            # "Tests are run long enough to reach a steady state": warm pass
            for b in range(working_set_buckets):
                node.put_latency_us(b)
            total = 0.0
            n = 0
            for _ in range(rounds):
                for b in range(working_set_buckets):
                    total += node.put_latency_us(b)
                    n += 1
            return total / n

        small = avg_put(buckets_in_m // 2)          # fits: ~pure RTT
        big = avg_put(int(buckets_in_m * 1.6))      # exceeds M+MAXVICTIM
        assert small == pytest.approx(cfg.rtt_us, rel=0.35)
        assert big > 2.0 * small                    # the Fig 2.3 cliff


# ---------------------------------------------------------------------------
# the port's numbers are the reference's, exactly
# ---------------------------------------------------------------------------
T, F = "TOUCHED", "FAULTING"
TAP, TA = "TOUCH_A_PAGE", "TOUCH_AHEAD"
#: (size, src prep, dst prep, strategy, timeout_us): every call above
REMOTE_WRITE_CASES = sorted({
    *((s, T, T, TA, None) for s in (16, 1024, 4096, 16384, 65536)),
    *((s, T, F, st, None) for s in (16, 256, 4096, 16384, 32768, 65536)
      for st in (TAP, TA)),
    *((s, F, T, st, None) for s in (16384, 32768, 65536)
      for st in (TAP, TA)),
    (16, F, T, TAP, None),
    *((s, F, F, TAP, None) for s in (16384, 65536)),
    *((16384, F, T, TAP, to) for to in (25000.0, 2500.0, 1000.0)),
}, key=str)


def _ids(case):
    size, sp, dp, st, to = case
    return f"{size}-{sp[0]}{dp[0]}-{st}" + (f"-to{to:g}" if to else "")


@pytest.mark.parametrize("case", REMOTE_WRITE_CASES, ids=_ids)
def test_run_remote_write_equals_the_reference_exactly(case):
    from repro.core import experiments as ref_experiments
    from repro.core.engine import BufferPrep as RefBufferPrep
    from repro.core.resolver import Strategy as RefStrategy
    size, sp, dp, st, to = case
    kw = {} if to is None else {"timeout_us": to}
    got = run_remote_write(size, BufferPrep[sp], BufferPrep[dp],
                           strategy=Strategy[st], **kw)
    want = ref_experiments.run_remote_write(
        size, RefBufferPrep[sp], RefBufferPrep[dp],
        strategy=RefStrategy[st], **kw)
    assert (got.size, got.latency_us, got.prep_us) == \
        (want.size, want.latency_us, want.prep_us)
    assert dataclasses.asdict(got.stats) == dataclasses.asdict(want.stats)


def _firehose_puts(cfg, sets, rounds=3) -> list:
    """Every put latency of C9's run: for each working set in turn, the
    warm pass, then ``rounds`` passes."""
    node = FirehoseNode(cfg)
    lats = []
    for n in sets:
        for _ in range(1 + rounds):
            lats += [node.put_latency_us(b) for b in range(n)]
    return lats


@pytest.mark.parametrize("upto", [1, 2], ids=["half_of_M", "past_M"])
def test_firehose_equals_the_reference_exactly(upto):
    """C9's node, its working sets (half the buckets of M, then 1.6x) in
    the order the claim runs them, up to the ``upto``-th."""
    from repro.core.firehose import FirehoseConfig as RefFirehoseConfig
    from repro.core.firehose import FirehoseNode as RefFirehoseNode
    kw = dict(M_bytes=4 << 20, maxvictim_bytes=1 << 20, n_nodes=2)
    cfg, ref_cfg = FirehoseConfig(**kw), RefFirehoseConfig(**kw)
    buckets_in_m = cfg.M_bytes // cfg.bucket_bytes
    sets = [buckets_in_m // 2, int(buckets_in_m * 1.6)][:upto]
    got = _firehose_puts(cfg, sets)
    node = RefFirehoseNode(ref_cfg)
    want = []
    for n in sets:
        for _ in range(4):
            want += [node.put_latency_us(b) for b in range(n)]
    assert got == want
