"""Exhaustive model checker over the product of the four lifecycles.

The AST conformance pass proves every *implemented* transition is in
spec; this module proves the *spec itself* is sound: starting from
(block=PENDING, wr=POSTED, tr_id=FRESH, bank=UNBOUND), it enumerates
every scenario in fault × retry-budget × crash × bank-steal and walks
the full reachable product state space under the protocol's event rules.

Checked properties (rule ``conf-model``):

* **no deadlock / no lost completion** — from every reachable state
  with the WR still POSTED, some path reaches a terminal WC status;
* **resources drain** — in every rest state (no event enabled) the WR
  is terminal, the tr_id is FREE (or still FRESH if never allocated),
  and the bank is released;
* **no unreachable spec state** — every declared state of every
  lifecycle is visited in some scenario;
* **no dead spec rows, no off-spec rows** — the union of transitions
  the model takes per lifecycle equals the spec table *exactly*.

The state space is tiny (hundreds of states per scenario), so the walk
is plain BFS — determinism of the linter itself matters (it gates CI),
hence the sorted iteration everywhere.
"""

from __future__ import annotations

import dataclasses
import itertools
from collections import deque
from typing import Callable, Dict, FrozenSet, List, Optional, Set, Tuple

from repro_torch.lint.common import Finding
from repro_torch.lint.specs import ALL_SPECS, BANK, BLOCK, TR_ID, WR

#: product state: block, wr, tr_id, bank, gen (0 = the id may still be
#: recycled into a follow-up transfer, to exercise FREE -> OWNED)
State = Tuple[str, str, str, str, int]


@dataclasses.dataclass(frozen=True)
class Scenario:
    fault: str      # none | src | dst | both
    budget: str     # unbounded | bounded
    crash: str      # none | src | dst
    steal: bool

    def label(self) -> str:
        return (f"fault={self.fault},budget={self.budget},"
                f"crash={self.crash},steal={self.steal}")


def scenarios() -> List[Scenario]:
    return [Scenario(f, b, c, s)
            for f, b, c, s in itertools.product(
                ("none", "src", "dst", "both"),
                ("unbounded", "bounded"),
                ("none", "src", "dst"),
                (False, True))]


#: an event: guard(scenario, state) -> bool, apply(state) -> state, and
#: which lifecycles it *acts on* (only those record transitions — a bank
#: bind does not "transition" the untouched block machine, and the
#: recycle event starts a NEW transfer rather than resurrecting a DONE
#: block)
@dataclasses.dataclass(frozen=True)
class Event:
    name: str
    guard: Callable[[Scenario, State], bool]
    apply: Callable[[State], State]
    acts_on: FrozenSet[str]


def _terminal_wr(wr: str) -> bool:
    return wr in WR.terminal


EVENTS: List[Event] = [
    Event("alloc",
          lambda sc, s: s[0] == "PENDING" and s[2] == "FRESH",
          lambda s: (s[0], s[1], "OWNED", s[3], s[4]),
          frozenset({"tr_id"})),
    Event("recycle",                       # a follow-up transfer reuses
          lambda sc, s: (sc.crash == "none" and s[4] == 0
                         and _terminal_wr(s[1]) and s[2] == "FREE"),
          lambda s: ("PENDING", "POSTED", "OWNED", s[3], 1),
          frozenset({"tr_id"})),
    Event("dispatch",
          lambda sc, s: (s[0] == "PENDING" and s[2] == "OWNED"
                         and s[1] == "POSTED"),
          lambda s: ("IN_FLIGHT",) + s[1:],
          frozenset({"block"})),
    Event("src_fault",
          lambda sc, s: sc.fault in ("src", "both")
          and s[0] == "IN_FLIGHT",
          lambda s: ("PAUSED_SRC",) + s[1:],
          frozenset({"block"})),
    Event("src_resolve",
          lambda sc, s: s[0] == "PAUSED_SRC",
          lambda s: ("IN_FLIGHT",) + s[1:],
          frozenset({"block"})),
    Event("nack",
          lambda sc, s: sc.fault in ("dst", "both")
          and s[0] in ("IN_FLIGHT", "PAUSED_SRC"),
          lambda s: ("PAUSED_DST",) + s[1:],
          frozenset({"block"})),
    Event("nack_retry",
          lambda sc, s: s[0] == "PAUSED_DST",
          lambda s: ("IN_FLIGHT",) + s[1:],
          frozenset({"block"})),
    Event("timeout_retry",                 # same state, new round_id
          lambda sc, s: s[0] == "IN_FLIGHT",
          lambda s: s,
          frozenset({"block"})),
    Event("ack",
          lambda sc, s: s[0] == "IN_FLIGHT" and s[1] == "POSTED",
          lambda s: ("DONE", "SUCCESS", "FREE", s[3], s[4]),
          frozenset({"block", "wr", "tr_id"})),
    Event("retry_exhaust",
          lambda sc, s: (sc.budget == "bounded" and s[1] == "POSTED"
                         and s[0] in ("IN_FLIGHT", "PAUSED_SRC",
                                      "PAUSED_DST")),
          lambda s: ("DONE", "RETRY_EXC_ERR", "FREE", s[3], s[4]),
          frozenset({"block", "wr", "tr_id"})),
    Event("crash_src",                     # local machine fails: flush
          lambda sc, s: sc.crash == "src" and s[1] == "POSTED",
          lambda s: ("DONE", "WR_FLUSH_ERR",
                     "LEASED" if s[2] == "OWNED" else s[2], s[3], s[4]),
          frozenset({"block", "wr", "tr_id"})),
    Event("lease_expiry",
          lambda sc, s: s[2] == "LEASED",
          lambda s: (s[0], s[1], "FREE", s[3], s[4]),
          frozenset({"tr_id"})),
    Event("dead_peer",                     # remote machine declared dead
          lambda sc, s: sc.crash == "dst" and s[1] == "POSTED",
          lambda s: ("DONE", "REMOTE_OP_ERR",
                     "FREE" if s[2] == "OWNED" else s[2], s[3], s[4]),
          frozenset({"block", "wr", "tr_id"})),
    Event("bind",
          lambda sc, s: s[3] == "UNBOUND" and s[1] == "POSTED",
          lambda s: s[:3] + ("BOUND", s[4]),
          frozenset({"bank"})),
    Event("steal",                         # another tenant evicts us
          lambda sc, s: sc.steal and s[3] == "BOUND" and s[1] == "POSTED",
          lambda s: s[:3] + ("UNBOUND", s[4]),
          frozenset({"bank"})),
    Event("rebind",                        # shootdown + immediate rebind
          lambda sc, s: sc.steal and s[3] == "BOUND" and s[1] == "POSTED",
          lambda s: s,
          frozenset({"bank"})),
    Event("release",                       # domain teardown at the end
          lambda sc, s: s[3] == "BOUND" and _terminal_wr(s[1]),
          lambda s: s[:3] + ("UNBOUND", s[4]),
          frozenset({"bank"})),
]

_COMPONENT = {"block": 0, "wr": 1, "tr_id": 2, "bank": 3}
_SPEC_OF = {"block": BLOCK, "wr": WR, "tr_id": TR_ID, "bank": BANK}

#: (event, lifecycle) pairs whose *unchanged* state is itself a spec'd
#: self-loop transition (a retry re-issues the same IN_FLIGHT block; a
#: shootdown+rebind keeps the domain BOUND).  Every other unchanged
#: component is simply untouched — e.g. crash_src leaves a FRESH tr_id
#: FRESH, which is no transition at all.
_SELF_LOOPS = {("timeout_retry", "block"), ("rebind", "bank")}

INITIAL: State = ("PENDING", "POSTED", "FRESH", "UNBOUND", 0)


@dataclasses.dataclass
class ModelResult:
    findings: List[Finding]
    states_explored: int
    taken: Dict[str, Set[Tuple[str, str]]]   # lifecycle -> transitions
    visited: Dict[str, Set[str]]             # lifecycle -> states seen


def _enabled(sc: Scenario, s: State) -> List[Event]:
    return [e for e in EVENTS if e.guard(sc, s)]


def check_model(path: str = "src/repro_torch/lint/specs.py") -> ModelResult:
    """Walk every scenario; findings carry rule ``conf-model`` and
    anchor to the spec module (the spec is what's being judged)."""
    findings: List[Finding] = []
    taken: Dict[str, Set[Tuple[str, str]]] = {
        k: set() for k in _COMPONENT}
    visited: Dict[str, Set[str]] = {k: set() for k in _COMPONENT}
    total = 0

    for sc in scenarios():
        seen: Set[State] = {INITIAL}
        frontier = deque([INITIAL])
        edges: Dict[State, List[State]] = {}
        while frontier:
            s = frontier.popleft()
            for name, idx in _COMPONENT.items():
                visited[name].add(s[idx])
            succs: List[State] = []
            for ev in _enabled(sc, s):
                s2 = ev.apply(s)
                for name in sorted(ev.acts_on):
                    idx = _COMPONENT[name]
                    pair = (s[idx], s2[idx])
                    if pair[0] == pair[1] \
                            and (ev.name, name) not in _SELF_LOOPS:
                        continue
                    taken[name].add(pair)
                    if pair not in _SPEC_OF[name].transitions:
                        findings.append(Finding(
                            "conf-model", path, 1,
                            f"[{sc.label()}] event {ev.name} takes "
                            f"{name} through {pair[0]} -> {pair[1]}, "
                            f"which is not a spec row"))
                succs.append(s2)
                if s2 not in seen:
                    seen.add(s2)
                    frontier.append(s2)
            edges[s] = succs
        total += len(seen)

        # ---- rest states: WR terminal, resources returned
        rest = [s for s in sorted(seen) if not edges[s]]
        for s in rest:
            if s[1] == "POSTED":
                findings.append(Finding(
                    "conf-model", path, 1,
                    f"[{sc.label()}] deadlock: no event enabled in "
                    f"{s} but the WR never completed"))
            if s[2] not in ("FREE", "FRESH"):
                findings.append(Finding(
                    "conf-model", path, 1,
                    f"[{sc.label()}] tr_id stuck {s[2]} at rest in {s}"))
            if s[3] != "UNBOUND":
                findings.append(Finding(
                    "conf-model", path, 1,
                    f"[{sc.label()}] bank never released at rest in {s}"))

        # ---- liveness: every POSTED state can still reach a terminal WR
        can_finish: Set[State] = {s for s in seen if _terminal_wr(s[1])}
        changed = True
        while changed:
            changed = False
            for s in seen:
                if s in can_finish:
                    continue
                if any(s2 in can_finish for s2 in edges[s]):
                    can_finish.add(s)
                    changed = True
        lost = sorted(s for s in seen if s not in can_finish)
        if lost:
            findings.append(Finding(
                "conf-model", path, 1,
                f"[{sc.label()}] {len(lost)} states cannot reach any WC "
                f"status (first: {lost[0]}) — lost completion"))

    # ---- spec-table exactness, across all scenarios
    for spec in ALL_SPECS:
        name = spec.name
        got = taken[name]
        want = set(spec.transitions)
        for pair in sorted(want - got):
            findings.append(Finding(
                "conf-model", path, 1,
                f"spec row {name}: {pair[0]} -> {pair[1]} is taken by no "
                f"model event — dead spec row (or missing event rule)"))
        missing_states = set(spec.states) - visited[name]
        for st in sorted(missing_states):
            findings.append(Finding(
                "conf-model", path, 1,
                f"spec state {name}.{st} is unreachable in every "
                f"scenario"))

    return ModelResult(findings=findings, states_explored=total,
                       taken=taken, visited=visited)


def run(files: object = None) -> List[Finding]:
    return check_model().findings
