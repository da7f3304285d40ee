"""Port vs reference, the verbs fabric and its simulator: the control plane
is the same Python in both packages (``tests/test_torch_hygiene.py``
holds the copies equal), so every seeded run must give the **same bytes**
— the soak stats of the default and the chaos tenants (the latter from
``tests/test_chaos.py``), under the race sanitizer and the sharded loop,
the Chapter-4 remote-write runs, the Firehose model, and the event wheel
against the heap.
"""

import dataclasses
import enum
import importlib
import random

import pytest

import repro.api as jax_api
import repro.testing as jax_testing
from repro.api import BufferPrep as JaxBufferPrep
from repro.core import experiments as jax_experiments
from repro.core import firehose as jax_firehose
from repro.core import simulator as jax_simulator
from repro.core.resolver import Strategy as JaxStrategy

import repro_torch.api as t_api
import repro_torch.testing as t_testing
from repro_torch.core import experiments as t_experiments
from repro_torch.core import firehose as t_firehose
from repro_torch.core import simulator as t_simulator

from test_chaos import CHAOS_CONFIG, CHAOS_INJECTION, CHAOS_TENANTS


def to_port(x):
    """A reference value (dataclass, enum, container) rebuilt from the
    port's class of the same module path and name."""
    if isinstance(x, enum.Enum) or (dataclasses.is_dataclass(x)
                                    and not isinstance(x, type)):
        mod = type(x).__module__
        assert mod.startswith("repro."), mod
        cls = getattr(importlib.import_module("repro_torch" + mod[5:]),
                      type(x).__name__)
        if isinstance(x, enum.Enum):
            return cls[x.name]
        return cls(**{f.name: to_port(getattr(x, f.name))
                      for f in dataclasses.fields(x) if f.init})
    if isinstance(x, (list, tuple)):
        return type(x)(to_port(v) for v in x)
    if isinstance(x, dict):
        return {k: to_port(v) for k, v in x.items()}
    return x


def test_to_port_rebuilds_the_chaos_settings_field_for_field():
    port = to_port(CHAOS_CONFIG)["config"]
    assert type(port).__module__ == "repro_torch.api.config"
    assert repr(port) == repr(CHAOS_CONFIG["config"])
    assert repr(to_port(CHAOS_TENANTS)) == repr(CHAOS_TENANTS)
    assert repr(to_port(CHAOS_INJECTION)) == repr(CHAOS_INJECTION)


def _both_soaks(seed, **kw):
    ref = jax_testing.soak(seed, **kw)
    port = t_testing.soak(seed, **to_port(kw))
    return ref, port


@pytest.mark.parametrize("seed", [0, 5, 7])
def test_default_soak_is_byte_identical(seed):
    ref, port = _both_soaks(seed)
    assert ref.ok and port.ok, (ref.violations, port.violations)
    assert port.json() == ref.json()


@pytest.mark.parametrize("seed", [7, 31, 99])
def test_chaos_soak_is_byte_identical(seed):
    ref, port = _both_soaks(seed, tenants=CHAOS_TENANTS,
                            injection=CHAOS_INJECTION, **CHAOS_CONFIG)
    assert ref.ok and port.ok, (ref.violations, port.violations)
    assert port.json() == ref.json()
    by_name = {t["tenant"]: t for t in port.stats["tenants"]}
    assert by_name["t23"]["aborted"] and by_name["t32"]["errors"] > 0


@pytest.mark.parametrize("cfg", [dict(race_check=True),
                                 dict(n_nodes=4, shards=2)],
                         ids=["race_check", "shards2"])
def test_soak_under_the_sanitizer_and_the_sharded_loop(cfg):
    ref, port = _both_soaks(3, config=jax_api.FabricConfig(**cfg))
    assert type(port.fabric.loop).__module__.startswith("repro_torch.")
    assert ref.ok and port.ok, (ref.violations, port.violations)
    assert port.json() == ref.json()
    assert port.violations == ref.violations


@pytest.mark.parametrize("prep", list(JaxBufferPrep), ids=lambda p: p.name)
@pytest.mark.parametrize("strategy", list(JaxStrategy), ids=lambda s: s.name)
def test_remote_write_runs_match(strategy, prep):
    """One remote write, to completion, for every strategy and buffer
    preparation, at a sub-page and a multi-block size: latency, prep cost
    and every ``TransferStats`` field equal."""
    for size in (1024, 65536):
        ref = jax_experiments.run_remote_write(size, prep, prep,
                                               strategy=strategy, n_nodes=2)
        port = t_experiments.run_remote_write(size, to_port(prep),
                                              to_port(prep),
                                              strategy=to_port(strategy),
                                              n_nodes=2)
        assert type(port.stats).__module__ == "repro_torch.core.node"
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)


def test_fault_and_ideal_sweeps_match():
    ref = jax_experiments.fault_sweep("both", JaxStrategy.TOUCH_AHEAD)
    port = t_experiments.fault_sweep("both", to_port(JaxStrategy.TOUCH_AHEAD))
    assert [dataclasses.asdict(r) for r in port] == \
        [dataclasses.asdict(r) for r in ref]
    ref = jax_experiments.ideal_sweep(JaxBufferPrep.PINNED)
    port = t_experiments.ideal_sweep(to_port(JaxBufferPrep.PINNED))
    assert [dataclasses.asdict(r) for r in port] == \
        [dataclasses.asdict(r) for r in ref]


def test_firehose_cliff_matches():
    """The Firehose working-set cliff (§2.3) put by put, and the two
    pinning alternatives it is compared with."""
    def run(fh):
        cfg = fh.FirehoseConfig(M_bytes=4 << 20, maxvictim_bytes=1 << 20,
                                n_nodes=2)
        node = fh.FirehoseNode(cfg)
        buckets = cfg.M_bytes // cfg.bucket_bytes
        lat = [node.put_latency_us(b) for ws in (buckets // 2,
                                                 int(buckets * 1.6))
               for _ in range(3) for b in range(ws)]
        other = [f(n) for n in (4096, 1 << 20)
                 for f in (fh.rendezvous_put_latency_us,
                           fh.bounce_buffer_put_latency_us)]
        return lat, other, (node.hits, node.misses, node.unpins,
                            node.hit_rate)

    ref, port = run(jax_firehose), run(t_firehose)
    assert port == ref
    assert max(port[0]) > 2 * min(port[0])           # the cliff is there


# ----------------------------------------------- event wheel vs binary heap
def _fire(log, loop, tag):
    log.append((loop.now, tag))


def _chain(log, loop, tag, delay):
    log.append((loop.now, tag))
    loop.schedule(delay, _fire, log, loop, -tag)


def _live(loop):
    if isinstance(loop, (t_simulator.HeapEventLoop,
                         jax_simulator.HeapEventLoop)):
        return len(loop._heap) - loop._n_cancelled
    return loop._n_queued - loop._n_cancelled


def _random_ops_trial(rng, n_ops=300):
    """``tests/test_event_loop_equiv.py``'s randomized trial, driven on the
    port's wheel and heap and on the reference's wheel at once."""
    loops = (t_simulator.EventLoop(), t_simulator.HeapEventLoop(),
             jax_simulator.EventLoop())
    logs = ([], [], [])
    handles = []
    tag = 0
    bucket = t_simulator.WHEEL_BUCKET_US
    span = t_simulator.WHEEL_SPAN
    assert (bucket, span) == (jax_simulator.WHEEL_BUCKET_US,
                              jax_simulator.WHEEL_SPAN)

    def check():
        assert len({lp.now for lp in loops}) == 1
        assert logs[0] == logs[1] == logs[2]
        assert len({lp.idle for lp in loops}) == 1
        assert len({_live(lp) for lp in loops}) == 1

    for _ in range(n_ops):
        op = rng.random()
        if op < 0.40:
            tag += 1
            kind = rng.random()
            if kind < 0.25:
                delay = 0.0
            elif kind < 0.60:
                delay = rng.uniform(0.0, 4 * bucket)
            elif kind < 0.90:
                delay = rng.uniform(0.0, span * bucket * 0.9)
            else:
                delay = rng.uniform(span * bucket, 8 * span * bucket)
            if rng.random() < 0.2:
                chain_delay = rng.uniform(0.0, 2 * bucket)
                handles.append(tuple(
                    lp.schedule(delay, _chain, lg, lp, tag, chain_delay)
                    for lp, lg in zip(loops, logs)))
            else:
                handles.append(tuple(lp.schedule(delay, _fire, lg, lp, tag)
                                     for lp, lg in zip(loops, logs)))
        elif op < 0.50 and handles:
            for ev in handles[rng.randrange(len(handles))]:
                ev.cancel()
                ev.cancel()
        elif op < 0.58:
            tag += 1
            t = loops[0].now + rng.uniform(-10.0, 100.0)
            for lp, lg in zip(loops, logs):
                lp.at(t, _fire, lg, lp, tag)
        elif op < 0.74:
            k = rng.randrange(1, 8)
            assert len({lp.run_batch(k) for lp in loops}) == 1
            check()
        elif op < 0.82:
            assert len({lp.step() for lp in loops}) == 1
            check()
        elif op < 0.92:
            assert len({lp.peek_time() for lp in loops}) == 1
        else:
            until = loops[0].now + rng.uniform(0.0, 200.0)
            for lp in loops:
                lp.run(until=until)
            check()

    for lp in loops:
        lp.run()
    check()
    assert len({lp.events_processed for lp in loops}) == 1
    assert all(lp.idle and lp._n_cancelled == 0 for lp in loops)


@pytest.mark.parametrize("seed", range(16))
def test_wheel_heap_and_reference_fire_alike(seed):
    _random_ops_trial(random.Random(seed))


def test_make_event_loop_reads_the_same_switch(monkeypatch):
    for value, name in (("heap", "HeapEventLoop"), ("wheel", "EventLoop")):
        monkeypatch.setenv("REPRO_EVENT_LOOP", value)
        assert type(t_simulator.make_event_loop()).__name__ == name
        assert type(jax_simulator.make_event_loop()).__name__ == name


def test_scale_mix_soak_sharded_is_byte_identical():
    """``tests/test_sharded.py``'s 8-node scale mix: the port's sharded
    executor (4 shards) against the reference's single wheel."""
    def run(testing, api, shards):
        specs = testing.scale_mix(8, total_blocks=1500, hot_blocks=256)
        config = api.FabricConfig(n_nodes=8, frames_per_node=1 << 14,
                                  shards=shards)
        return testing.soak(11, tenants=specs, config=config,
                            max_events=50_000_000)

    ref = run(jax_testing, jax_api, 1)
    port = run(t_testing, t_api, 4)
    assert ref.ok and port.ok, (ref.violations, port.violations)
    assert port.json() == ref.json()
