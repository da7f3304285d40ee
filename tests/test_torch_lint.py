"""The port's static lint passes (``repro_torch.lint``) against the
reference's (``repro.lint``): the twin of ``tests/test_lint.py``.

Each fixture goes through the reference's pass at a ``src/repro/...`` path
and through the port's at the matching ``src/repro_torch/...`` path; both
must give the same findings (rule, line and message, the path mapped), and
the findings the reference's test expects.  Then the port's gate is run on
the repository: its spec round trip, its model check and its CLI.

Suppression markers inside fixtures are assembled at run time, so that
neither package's raw-line scan of this file sees a live allow() comment.
"""

import dataclasses
import json
import re
import subprocess
import sys
import textwrap
import types
from pathlib import Path

import pytest

from repro.lint import (cli as ref_cli, conformance as ref_conformance,
                        determinism as ref_determinism, model as ref_model,
                        stats_coverage as ref_stats_coverage,
                        typed_errors as ref_typed_errors)
from repro.lint.common import SourceFile as RefSourceFile
from repro_torch.api import Fabric, FabricConfig
from repro_torch.core.simulator import EventLoop
from repro_torch.lint import (cli, conformance, determinism, model,
                              stats_coverage, typed_errors)
from repro_torch.lint.common import KNOWN_RULES, SourceFile, collect_files
from repro_torch.lint.race import RaceCheckLoop, footprint_of
from repro_torch.lint.specs import ALL_SPECS, BLOCK, WC_ERROR_STATUSES
from repro_torch.testing import soak

ROOT = Path(__file__).resolve().parents[1]
#: the port's example twins, which the gate lints beside the port
EXAMPLE_TWINS = sorted(p.relative_to(ROOT).as_posix()
                       for p in ROOT.glob("examples/torch_*.py"))

EVENT_PATH = "src/repro/core/fixture.py"      # det-dict-iter/id-order scope
OFF_PATH = "src/repro/launch/fixture.py"      # in repro, off the event path
API_PATH = "src/repro/api/fixture.py"         # typed-raise scope
INVARIANTS_REL = "src/repro/testing/invariants.py"

#: runtime-assembled so no raw line of this file parses as a suppression
ALLOW = "# torch-" + "lint: " + "allow"       # the port's marker
REF_ALLOW = "# " + "lint: " + "allow"         # the reference's marker

REF_PASSES = {"determinism": ref_determinism, "typed_errors": ref_typed_errors,
              "stats_coverage": ref_stats_coverage,
              "conformance": ref_conformance}
PORT_PASSES = {"determinism": determinism, "typed_errors": typed_errors,
               "stats_coverage": stats_coverage, "conformance": conformance}


def port_rel(rel):
    return rel.replace("src/repro/", "src/repro_torch/", 1)


def mapped(findings):
    """Port findings with their paths written as the reference's."""
    def ref(text):
        return text.replace("src/repro_torch/", "src/repro/").replace(
            "repro_torch.", "repro.")
    return sorted((f.rule, ref(f.path), f.line, ref(f.message))
                  for f in findings)


def flat(findings):
    return sorted((f.rule, f.path, f.line, f.message) for f in findings)


def rules(findings):
    return sorted(f.rule for f in findings)


def twin(fn, fixtures):
    """Run ``fn(module, files)`` on both packages over ``fixtures`` (pairs
    of text and reference path) and hold the findings equal."""
    ref_files = [RefSourceFile(rel, textwrap.dedent(t)) for t, rel in fixtures]
    port_files = [SourceFile(port_rel(rel), textwrap.dedent(t))
                  for t, rel in fixtures]
    ref, port = fn("ref", ref_files), fn("port", port_files)
    assert mapped(port) == flat(ref)
    return port


def run_pass(name):
    def fn(side, files):
        return (REF_PASSES if side == "ref" else PORT_PASSES)[name].run(files)
    return fn


def det(text, rel=EVENT_PATH):
    return rules(twin(run_pass("determinism"), [(text, rel)]))


# ---------------------------------------------------------------------------
# determinism rules
# ---------------------------------------------------------------------------
DETERMINISM_CASES = [
    ("set_iter_flagged", """
        def visit(fn):
            for x in {1, 2, 3}:
                fn(x)
        """, EVENT_PATH, ["det-set-iter"]),
    ("set_iter_sorted_ok", """
        def visit(fn):
            for x in sorted({1, 2, 3}):
                fn(x)
        """, EVENT_PATH, []),
    # plain names: could be ints; not provably setlike
    ("set_algebra_flagged", """
        def visit(a, b, fn):
            for x in a | b:
                fn(x)
        """, EVENT_PATH, []),
    ("set_literal_algebra_flagged", """
        def visit(b, fn):
            for x in {1, 2} | b:
                fn(x)
        """, EVENT_PATH, ["det-set-iter"]),
    ("dict_iter_event_path_flagged", """
        def drain(d, out):
            for k, v in d.items():
                out.append(k)
        """, EVENT_PATH, ["det-dict-iter"]),
    ("dict_iter_off_event_path_ok", """
        def drain(d, out):
            for k, v in d.items():
                out.append(k)
        """, OFF_PATH, []),
    ("dict_iter_sorted_ok", """
        def drain(d, out):
            for k in sorted(d.keys()):
                out.append(k)
        """, EVENT_PATH, []),
    # the genexp's consumer (sum) is order-insensitive
    ("sum_genexp_over_dict_values_ok", """
        def depth(queues):
            return sum(len(q.blocks) for q in queues.values())
        """, EVENT_PATH, []),
    ("setcomp_over_dict_values_ok", """
        def live(d):
            return {v for v in d.values()}
        """, EVENT_PATH, []),
    ("listcomp_over_dict_values_flagged", """
        def order(d):
            return [v for v in d.values()]
        """, EVENT_PATH, ["det-dict-iter"]),
    ("wallclock_flagged", """
        import time
        def stamp():
            return time.time()
        """, EVENT_PATH, ["det-wallclock"]),
    ("wallclock_at_module_level_flagged", """
        import time
        T0 = time.perf_counter()
        """, EVENT_PATH, ["det-wallclock"]),
    ("virtual_time_ok", """
        def stamp(loop):
            return loop.now
        """, EVENT_PATH, []),
    ("unseeded_random_flagged", """
        import random
        def roll():
            return random.randint(0, 7)
        """, EVENT_PATH, ["det-unseeded-random"]),
    ("seeded_random_instance_ok", """
        import random
        def roll(seed):
            rng = random.Random(seed)
            return rng.randint(0, 7)
        """, EVENT_PATH, []),
    ("id_as_key_flagged_on_event_path", """
        def index(objs, m):
            for o in objs:
                m[id(o)] = o
        """, EVENT_PATH, ["det-id-order"]),
    ("id_dedup_ok", """
        def dedup(objs, seen):
            for o in objs:
                if id(o) == id(objs[0]):
                    continue
                seen.add(id(o))
        """, EVENT_PATH, []),
    ("id_off_event_path_ok", """
        def index(objs, m):
            for o in objs:
                m[id(o)] = o
        """, OFF_PATH, []),
    ("heap_push_without_tiebreak_flagged", """
        import heapq
        def push(h, t, obj):
            heapq.heappush(h, (t, obj))
        """, EVENT_PATH, ["det-heap-tiebreak"]),
    ("heap_push_with_counter_ok", """
        import heapq
        def push(h, c, t, obj):
            heapq.heappush(h, (t, next(c), obj))
        """, EVENT_PATH, []),
    ("heap_repush_popped_entry_ok", """
        import heapq
        def rotate(h):
            entry = heapq.heappop(h)
            heapq.heappush(h, entry)
        """, EVENT_PATH, []),
]


class TestDeterminismRules:
    @pytest.mark.parametrize("text,rel,want",
                             [c[1:] for c in DETERMINISM_CASES],
                             ids=[c[0] for c in DETERMINISM_CASES])
    def test_rule_matches_the_reference(self, text, rel, want):
        assert det(text, rel) == want

    def test_files_outside_the_port_are_not_linted(self):
        """The port's passes read ``src/repro_torch/`` only, as the
        reference's read ``src/repro/`` only."""
        text = textwrap.dedent(DETERMINISM_CASES[0][1])
        assert determinism.run([SourceFile(EVENT_PATH, text)]) == []
        assert ref_determinism.run(
            [RefSourceFile(port_rel(EVENT_PATH), text)]) == []


# ---------------------------------------------------------------------------
# typed-raise
# ---------------------------------------------------------------------------
class TestTypedErrors:
    def bad(self, rel):
        return rules(twin(run_pass("typed_errors"), [("""
            def f():
                raise ValueError("bad knob")
            """, rel)]))

    def test_bare_raise_at_api_surface_flagged(self):
        assert self.bad(API_PATH) == ["typed-raise"]
        assert self.bad("src/repro/tenancy/fixture.py") == ["typed-raise"]

    def test_core_is_out_of_scope(self):
        assert self.bad(EVENT_PATH) == []

    def test_typed_error_ok(self):
        assert rules(twin(run_pass("typed_errors"), [("""
            from repro_torch.errors import ConfigError
            def f():
                raise ConfigError("bad knob")
            """, API_PATH)])) == []

    def test_reraise_and_typeerror_ok(self):
        assert rules(twin(run_pass("typed_errors"), [("""
            def f(x):
                if not isinstance(x, int):
                    raise TypeError("x must be int")
                try:
                    return 1 // x
                except ZeroDivisionError:
                    raise
            """, API_PATH)])) == []


# ---------------------------------------------------------------------------
# stats-coverage
# ---------------------------------------------------------------------------
STATS_FIXTURE = """
    class FooStats:
        lost: int = 0
        seen: int = 0
    """


def _foo_findings(inv_body):
    found = twin(run_pass("stats_coverage"),
                 [(STATS_FIXTURE, "src/repro/core/metrics.py"),
                  (inv_body, INVARIANTS_REL)])
    return [f for f in found if "FooStats" in f.message]


class TestStatsCoverage:
    def test_unchecked_counter_flagged(self):
        found = _foo_findings("""
            def check_foo(s):
                return ["bad"] if s.seen < 0 else []
            """)
        assert rules(found) == ["stats-coverage"]
        assert "FooStats.lost" in found[0].message

    def test_checked_counter_ok(self):
        assert _foo_findings("""
            def check_foo(s):
                return ["bad"] if s.lost != s.seen else []
            """) == []

    def test_missing_invariants_module_is_itself_a_finding(self):
        found = twin(run_pass("stats_coverage"),
                     [(STATS_FIXTURE, "src/repro/core/metrics.py")])
        assert rules(found) == ["stats-coverage"]
        assert "cannot prove" in found[0].message
        assert "src/repro_torch/testing/invariants.py" in found[0].message


# ---------------------------------------------------------------------------
# conformance: transitions, state names, mutators, statuses
# ---------------------------------------------------------------------------
def _extract(text):
    got = {}

    def fn(side, files):
        mod = ref_conformance if side == "ref" else conformance
        findings, got[side] = mod.extract_block_transitions(files)
        return findings
    findings = twin(fn, [(text, EVENT_PATH)])
    assert got["port"] == got["ref"]
    return findings, got["port"]


def _conf(name, text, rel=EVENT_PATH):
    def fn(side, files):
        mod = ref_conformance if side == "ref" else conformance
        return getattr(mod, name)(files)
    return twin(fn, [(text, rel)])


class TestConformance:
    def test_unguarded_write_flags_illegal_pairs(self):
        findings, observed = _extract("""
            def regress(self, block):
                block.state = BlockState.PENDING
            """)
        assert "conf-transition" in rules(findings)
        # unguarded: every from-state is possible, including DONE
        assert ("DONE", "PENDING") in observed

    def test_guarded_write_extracts_exact_pair(self):
        findings, observed = _extract("""
            def on_ack(self, block):
                if block.state is BlockState.IN_FLIGHT:
                    block.state = BlockState.DONE
            """)
        assert findings == []
        assert observed == {("IN_FLIGHT", "DONE")}

    def test_init_must_start_in_spec_initial_state(self):
        bad, _ = _extract("""
            class Block:
                def __init__(self):
                    self.state = BlockState.DONE
            """)
        assert rules(bad) == ["conf-transition"]
        good, _ = _extract("""
            class Block:
                def __init__(self):
                    self.state = BlockState.PENDING
            """)
        assert good == []

    def test_state_name_typo_flagged(self):
        assert rules(_conf("check_state_names", """
            from enum import Enum
            class BlockState(Enum):
                PENDING = 1
            def f(b):
                return b.state.name == "PENDNIG"
            """)) == ["conf-state-name"]

    def test_state_name_spelled_right_ok(self):
        assert _conf("check_state_names", """
            from enum import Enum
            class BlockState(Enum):
                PENDING = 1
            def f(b):
                return b.state.name == "PENDING"
            """) == []

    def test_foreign_tr_id_mutation_flagged(self):
        found = _conf("check_mutators", """
            def hack(node, tid, blocks):
                node.r5.pending[tid] = blocks
            """, rel=API_PATH)
        assert rules(found) == ["conf-mutator"]
        assert "pending" in found[0].message
        assert "src/repro_torch/core/node.py" in found[0].message

    def test_bad_fail_transfer_status_flagged(self):
        assert rules(_conf("check_statuses", """
            def kill(self, t):
                self.r5.fail_transfer(t, "bogus")
            """)) == ["conf-status"]

    @pytest.mark.parametrize("status", WC_ERROR_STATUSES)
    def test_spec_statuses_ok(self, status):
        assert _conf("check_statuses", f"""
            def kill(self, t):
                self.r5.fail_transfer(t, "{status}")
            """) == []


# ---------------------------------------------------------------------------
# spec round-trip against the port's sources
# ---------------------------------------------------------------------------
class TestSpecRoundTrip:
    """The spec tables and the port agree: every spec'd block transition
    has a guarded write site in ``src/repro_torch/`` and none exceeds the
    spec."""

    @pytest.fixture(scope="class")
    def src_files(self):
        return collect_files(["src"], ROOT)

    def test_block_transitions_round_trip(self, src_files):
        findings, observed = conformance.extract_block_transitions(src_files)
        assert findings == []
        assert observed == set(BLOCK.transitions)
        assert len(observed) == 11

    def test_conformance_pass_clean_on_repo(self, src_files):
        assert conformance.run(src_files) == []

    def test_typed_errors_clean_on_repo(self, src_files):
        assert typed_errors.run(src_files) == []

    def test_the_port_is_what_was_read(self, src_files):
        """The transitions come from ``src/repro_torch/``: the reference's
        sources alone give the port's extractor none."""
        rest = [f for f in src_files
                if not f.rel.startswith("src/repro_torch/")]
        assert rest
        _, observed = conformance.extract_block_transitions(rest)
        assert observed == set()


# ---------------------------------------------------------------------------
# the spec model checker
# ---------------------------------------------------------------------------
class TestModelChecker:
    @pytest.fixture(scope="class")
    def result(self):
        return model.check_model()

    def test_model_clean(self, result):
        assert result.findings == []
        assert result.states_explored == 832
        assert len(model.scenarios()) == 48

    def test_model_equals_the_reference(self, result):
        ref = ref_model.check_model()
        assert result.states_explored == ref.states_explored
        assert result.taken == ref.taken
        assert result.visited == ref.visited

    def test_every_spec_row_exercised(self, result):
        for spec in ALL_SPECS:
            assert result.taken[spec.name] == set(spec.transitions)

    def test_every_spec_state_reachable(self, result):
        for spec in ALL_SPECS:
            assert result.visited[spec.name] == set(spec.states)

    def test_scenarios_cover_fault_and_crash_axes(self):
        scs = model.scenarios()
        assert len(scs) == len({sc.label() for sc in scs})
        assert any(sc.crash != "none" for sc in scs)
        assert any(sc.budget == "bounded" for sc in scs)
        assert any(sc.fault == "both" for sc in scs)


# ---------------------------------------------------------------------------
# suppressions
# ---------------------------------------------------------------------------
def _lint_both(text, rel=EVENT_PATH):
    """The port's CLI on ``text`` with the port's marker, held to the
    reference's CLI on the same text with the reference's marker."""
    port = cli.lint([SourceFile(port_rel(rel), text)], with_model=False)
    ref = ref_cli.lint([RefSourceFile(rel, text.replace(ALLOW, REF_ALLOW))],
                       with_model=False)
    assert mapped(port) == flat(ref)
    return port


class TestSuppressions:
    def test_justified_allow_suppresses(self):
        text = ("import time\n\nT0 = time.time()  "
                + ALLOW + "(det-wallclock): host telemetry only\n")
        assert _lint_both(text) == []

    def test_line_above_form_suppresses(self):
        text = ("import time\n\n"
                + ALLOW + "(det-wallclock): host telemetry only\n"
                + "T0 = time.time()\n")
        assert _lint_both(text) == []

    def test_allow_without_justification_is_a_finding(self):
        text = ("import time\n\nT0 = time.time()  "
                + ALLOW + "(det-wallclock)\n")
        assert rules(_lint_both(text)) == ["lint-suppression"]

    def test_unknown_rule_is_a_finding(self):
        text = "X = 1  " + ALLOW + "(no-such-rule): because\n"
        assert "lint-suppression" in rules(_lint_both(text))

    def test_unused_allow_is_a_finding(self):
        text = "X = 1  " + ALLOW + "(det-wallclock): stale comment\n"
        assert rules(_lint_both(text)) == ["lint-unused-suppression"]

    def test_reference_marker_is_not_a_port_suppression(self):
        """In a port file the reference's marker suppresses nothing and is
        not even read as a suppression; the port's marker is likewise
        nothing to the reference's gate, which reads these files too."""
        text = ("import time\n\nT0 = time.time()  "
                + REF_ALLOW + "(det-wallclock): host telemetry only\n")
        port = SourceFile(port_rel(EVENT_PATH), text)
        assert port.suppressions == {}
        assert rules(cli.lint([port], with_model=False)) == ["det-wallclock"]
        ref = RefSourceFile(port_rel(EVENT_PATH), text.replace(REF_ALLOW,
                                                               ALLOW))
        assert ref.suppressions == {}
        assert ref_cli.lint([ref], with_model=False) == []

    def test_every_repo_suppression_names_a_known_rule(self):
        files = collect_files(["src", "tests", "chip_smoke.py",
                               *EXAMPLE_TWINS], ROOT)
        sups = [(f.rel, s) for f in files for s in f.suppressions.values()]
        assert sups, "the port carries suppressions"
        for rel, sup in sups:
            assert rel.startswith("src/repro_torch/"), rel
            assert set(sup.rules) <= set(KNOWN_RULES), f"{rel}:{sup.line}"
            assert sup.justification, f"{rel}:{sup.line}"


# ---------------------------------------------------------------------------
# same-timestamp race sanitizer
# ---------------------------------------------------------------------------
def _writer(key):
    def cb():
        pass
    cb.__race_footprint__ = lambda args: (frozenset(), frozenset({key}))
    return cb


def _reader(key):
    def cb():
        pass
    cb.__race_footprint__ = lambda args: (frozenset({key}), frozenset())
    return cb


def _race(*events):
    loop = RaceCheckLoop()
    for t, cb in events:
        loop.at(t, cb)
    loop.run()
    loop.flush()
    return loop


class TestRaceSanitizer:
    def test_planted_write_write_race_detected(self):
        loop = _race((5.0, _writer(("wr", 1))), (5.0, _writer(("wr", 1))))
        assert len(loop.reports) == 1
        assert "conflict" in loop.reports[0]

    def test_read_write_race_detected(self):
        loop = _race((5.0, _writer(("wr", 1))), (5.0, _reader(("wr", 1))))
        assert len(loop.reports) == 1

    def test_read_read_is_not_a_race(self):
        loop = _race((5.0, _reader(("wr", 1))), (5.0, _reader(("wr", 1))))
        assert loop.reports == []

    def test_different_times_never_conflict(self):
        loop = _race((5.0, _writer(("wr", 1))), (6.0, _writer(("wr", 1))))
        assert loop.reports == []

    def test_disjoint_keys_never_conflict(self):
        loop = _race((5.0, _writer(("wr", 1))), (5.0, _writer(("wr", 2))))
        assert loop.reports == []

    def test_unknown_callbacks_are_tallied(self):
        loop = _race((5.0, lambda: None))
        assert sum(loop.unknown_callbacks.values()) == 1
        assert loop.reports == []

    def test_generic_footprint_from_block_argument(self):
        blk = types.SimpleNamespace(
            tr_id=1, round_id=0, index=2,
            transfer=types.SimpleNamespace(tid=3))
        (reads, writes), known = footprint_of(lambda b: None, (blk,))
        assert known
        assert reads == frozenset()
        assert writes == {("block", 3, 2)}

    def test_config_opt_in(self):
        fab = Fabric.build(FabricConfig(n_nodes=2, race_check=True))
        assert isinstance(fab.loop, RaceCheckLoop)
        plain = Fabric.build(FabricConfig(n_nodes=2))
        assert not isinstance(plain.loop, RaceCheckLoop)
        assert isinstance(plain.loop, EventLoop)

    def test_env_opt_in(self, monkeypatch):
        monkeypatch.setenv("REPRO_RACE_CHECK", "1")
        fab = Fabric.build(FabricConfig(n_nodes=2))
        assert isinstance(fab.loop, RaceCheckLoop)

    @pytest.mark.parametrize("topology", ["all_to_all", "ring"])
    def test_soak_transparent_and_clean(self, topology):
        """Instrumented soaks report zero conflicts and stay byte-identical
        to uninstrumented ones."""
        cfg = FabricConfig(n_nodes=3, topology=topology)
        plain = soak(17, config=cfg)
        raced = soak(17, config=dataclasses.replace(cfg, race_check=True))
        assert plain.violations == []
        assert raced.violations == []
        assert (json.dumps(plain.stats, sort_keys=True)
                == json.dumps(raced.stats, sort_keys=True))


# ---------------------------------------------------------------------------
# the CLI (the port's gate)
# ---------------------------------------------------------------------------
class TestCli:
    def test_port_is_lint_clean(self, capsys):
        assert cli.main(["src", "tests", "chip_smoke.py", *EXAMPLE_TWINS,
                         "--root", str(ROOT), "-q"]) == 0

    def test_gate_as_a_module(self):
        """``python -m repro_torch.lint src tests chip_smoke.py
        examples/torch_*.py``: exit 0, no finding, the 16 suppressions
        used, every block transition extracted and the model explored in
        full."""
        r = subprocess.run(
            [sys.executable, "-m", "repro_torch.lint", "src", "tests",
             "chip_smoke.py", *EXAMPLE_TWINS], cwd=ROOT, capture_output=True,
            text=True,
            timeout=120, env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"})
        assert r.returncode == 0, r.stdout + r.stderr
        assert r.stdout == ""
        assert re.search(r"^repro_torch\.lint: \d+ files, 15 rules, "
                         r"0 findings, 16 suppressed$", r.stderr, re.M)
        assert ("repro_torch.lint: conformance extracted 11/11 block "
                "transitions across 4 lifecycles; model explored 832 "
                "states over 48 scenarios") in r.stderr

    def test_findings_exit_nonzero(self, tmp_path, capsys):
        bad = tmp_path / "bad.py"
        bad.write_text("X = 1  " + ALLOW + "(no-such-rule): whatever\n")
        assert cli.main(["bad.py", "--root", str(tmp_path),
                         "-q", "--no-model"]) == 1

    def test_finding_in_a_port_file_exits_nonzero(self, tmp_path, capsys):
        rel = tmp_path / "src" / "repro_torch" / "core" / "bad.py"
        rel.parent.mkdir(parents=True)
        rel.write_text("import time\nT0 = time.time()\n")
        assert cli.main(["src", "--root", str(tmp_path),
                         "--no-model"]) == 1
        assert "[det-wallclock]" in capsys.readouterr().out

    def test_no_files_exits_2(self, tmp_path, capsys):
        assert cli.main(["nothing-here", "--root", str(tmp_path),
                         "-q", "--no-model"]) == 2
