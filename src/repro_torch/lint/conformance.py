"""Protocol conformance: implementation AST vs the specs in ``specs.py``.

Four checks, one rule id each:

``conf-transition``
    Every ``<x>.state = BlockState.Y`` assignment is analysed for its
    possible *from*-states (intraprocedural guard analysis, below) and
    each resulting ``(from, to)`` pair must be a row of
    :data:`~repro_torch.lint.specs.BLOCK`.  An unguarded write that could move
    a DONE block, or any transition the paper's protocol doesn't have,
    fails the build.
``conf-state-name``
    String comparisons against ``<x>.state.name`` must name a member of
    some declared enum — catches the ``"DNOE"`` typo class that a
    ``is BlockState.DONE`` comparison can't have.
``conf-mutator``
    The tr_id and bank lifecycles aren't enum fields; their state *is*
    the containers (``R5Scheduler.pending``/``_free``/..., the
    ``BankManager`` tables).  Each watched container may be mutated only
    by the methods :data:`~repro_torch.lint.specs.TR_ID_FIELDS` /
    :data:`~repro_torch.lint.specs.BANK_FIELDS` sanction (plus ``__init__``),
    and never from outside the owning class.
``conf-status``
    WC statuses: ``fail_transfer`` call sites pass a spec'd error
    literal (or the ``_crash_status`` chooser), ``_crash_status``
    returns only spec'd literals, the ``WCStatus`` enum and
    ``invariants.FAILED_STATUSES`` mirror the spec exactly, and
    ``fail_transfer``'s first statement is the exactly-once guard.

Guard analysis (``conf-transition``): statements of the enclosing
function are walked in order, tracking the set of states the target
could be in — ``if <state test>: return`` prunes by the test's
negation, an earlier ``.state = X`` assignment narrows to ``{X}``,
``assert``/``if`` tests restrict their scope, and loop bodies feed back
only those states whose suite can reach the back edge.  The analysis is
deliberately *pessimistic*: anything it can't see leaves the from-set
wide, so the fix for a false positive is an explicit guard or assert —
which is exactly the self-documenting code the pass exists to force.
"""

from __future__ import annotations

import ast
from typing import (Dict, FrozenSet, Iterable, List, Optional, Sequence, Set,
                    Tuple)

from repro_torch.lint.common import (Finding, SourceFile, add_parents, call_name,
                               dotted_name, enclosing_function, parent,
                               qualname_of)
from repro_torch.lint.specs import (BANK_FIELDS, BLOCK, TR_ID_FIELDS,
                              WC_ERROR_STATUSES, WC_SUCCESS)

_STATES: FrozenSet[str] = frozenset(BLOCK.states)

_MUTATING_METHODS = {"append", "appendleft", "pop", "popleft", "clear",
                     "remove", "add", "update", "setdefault", "extend",
                     "insert", "discard", "popitem"}

_TERMINAL = (ast.Return, ast.Raise, ast.Break, ast.Continue)


# ------------------------------------------------------------ AST helpers
def _state_literal(node: ast.AST) -> Optional[str]:
    """``BlockState.X`` -> ``"X"``."""
    if isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name) \
            and node.value.id == "BlockState" and node.attr in _STATES:
        return node.attr
    return None


def _is_state_lvalue(node: ast.AST) -> Optional[str]:
    """``<name>.state`` -> the base name, else None."""
    if isinstance(node, ast.Attribute) and node.attr == "state" \
            and isinstance(node.value, ast.Name):
        return node.value.id
    return None


def _reads_state_of(node: ast.AST, var: str) -> bool:
    return _is_state_lvalue(node) == var


def _restriction(test: ast.AST, var: str) -> Optional[FrozenSet[str]]:
    """States of ``var`` for which ``test`` holds, or None (no info)."""
    if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
        inner = _restriction(test.operand, var)
        return None if inner is None else _STATES - inner
    if isinstance(test, ast.BoolOp) and isinstance(test.op, ast.And):
        parts = [_restriction(v, var) for v in test.values]
        known = [p for p in parts if p is not None]
        if not known:
            return None
        out = _STATES
        for p in known:
            out &= p
        return out
    if not (isinstance(test, ast.Compare) and len(test.ops) == 1):
        return None
    left, op, right = test.left, test.ops[0], test.comparators[0]
    # `<var>.state is/== BlockState.X`  (and the .name string form)
    lit: Optional[Set[str]] = None
    if _reads_state_of(left, var):
        one = _state_literal(right)
        if one is not None:
            lit = {one}
        elif isinstance(right, (ast.Tuple, ast.List, ast.Set)):
            members = [_state_literal(e) for e in right.elts]
            if all(m is not None for m in members):
                lit = set(members)           # type: ignore[arg-type]
    elif isinstance(left, ast.Attribute) and left.attr == "name" \
            and _is_state_lvalue(left.value) == var \
            and isinstance(right, ast.Constant) \
            and isinstance(right.value, str) and right.value in _STATES:
        lit = {right.value}
    if lit is None:
        return None
    if isinstance(op, (ast.Is, ast.Eq, ast.In)):
        return frozenset(lit)
    if isinstance(op, (ast.IsNot, ast.NotEq, ast.NotIn)):
        return _STATES - lit
    return None


def _negation(test: ast.AST, var: str) -> Optional[FrozenSet[str]]:
    """States for which ``test`` is false — handles ``A or B`` guards
    (fallthrough of ``if A or B: return`` implies both false)."""
    if isinstance(test, ast.BoolOp) and isinstance(test.op, ast.Or):
        out = _STATES
        for v in test.values:
            r = _restriction(v, var)
            if r is not None:
                out &= _STATES - r
        return out if out != _STATES else None
    r = _restriction(test, var)
    return None if r is None else _STATES - r


def _suite_terminal(suite: Sequence[ast.stmt], after: ast.stmt) -> bool:
    """Does ``suite`` unconditionally leave the loop/function after the
    statement ``after`` (so a loop-body assignment can't feed back)?"""
    seen = False
    for stmt in suite:
        if stmt is after:
            seen = True
            continue
        if seen and isinstance(stmt, _TERMINAL):
            return True
    return seen and isinstance(suite[-1], _TERMINAL)


def _loop_feedback(body: Sequence[ast.stmt], var: str) -> Set[str]:
    """States assigned to ``var.state`` inside a loop body that can
    survive to the back edge (their suite doesn't end terminally)."""
    out: Set[str] = set()
    for stmt in body:
        for node in ast.walk(stmt):
            if not isinstance(node, ast.Assign):
                continue
            tgt = node.targets[0] if len(node.targets) == 1 else None
            if tgt is None or _is_state_lvalue(tgt) != var:
                continue
            lit = _state_literal(node.value)
            if lit is None:
                out |= set(_STATES)
                continue
            up = parent(node)
            suite = None
            if up is not None:
                for field in ("body", "orelse", "finalbody"):
                    cand = getattr(up, field, None)
                    if isinstance(cand, list) and node in cand:
                        suite = cand
                        break
            if suite is None or not _suite_terminal(suite, node):
                out.add(lit)
    return out


# ------------------------------------------------- from-state computation
def _scan(stmts: Sequence[ast.stmt], possible: FrozenSet[str],
          site: ast.Assign, var: str
          ) -> Tuple[str, FrozenSet[str]]:
    """Walk a suite; returns ('found', states-at-site),
    ('term', _) if the suite always leaves, or ('fall', states-after)."""
    for stmt in stmts:
        if stmt is site:
            return "found", possible
        if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 \
                and _is_state_lvalue(stmt.targets[0]) == var:
            lit = _state_literal(stmt.value)
            possible = frozenset({lit}) if lit is not None else _STATES
            continue
        if isinstance(stmt, ast.Assert):
            r = _restriction(stmt.test, var)
            if r is not None:
                possible &= r
            continue
        if isinstance(stmt, _TERMINAL):
            return "term", possible
        if isinstance(stmt, ast.If):
            r = _restriction(stmt.test, var)
            body_p = possible & r if r is not None else possible
            st, p = _scan(stmt.body, body_p, site, var)
            if st == "found":
                return st, p
            n = _negation(stmt.test, var)
            else_p = possible & n if n is not None else possible
            st2, p2 = ("fall", else_p)
            if stmt.orelse:
                st2, p2 = _scan(stmt.orelse, else_p, site, var)
                if st2 == "found":
                    return st2, p2
            after: FrozenSet[str] = frozenset()
            if st == "fall":
                after |= p
            if st2 == "fall":
                after |= p2
            if not after:
                return "term", possible
            possible = after
            continue
        if isinstance(stmt, (ast.For, ast.While)):
            widened = possible | _loop_feedback(stmt.body, var)
            st, p = _scan(stmt.body, widened, site, var)
            if st == "found":
                return st, p
            if stmt.orelse:
                st2, p2 = _scan(stmt.orelse, widened, site, var)
                if st2 == "found":
                    return st2, p2
            possible = widened
            continue
        if isinstance(stmt, ast.Try):
            st, p = _scan(stmt.body, possible, site, var)
            if st == "found":
                return st, p
            after = p if st == "fall" else frozenset()
            for handler in stmt.handlers:
                st2, p2 = _scan(handler.body, possible, site, var)
                if st2 == "found":
                    return st2, p2
                if st2 == "fall":
                    after |= p2
            if stmt.finalbody:
                st3, p3 = _scan(stmt.finalbody, after or possible, site, var)
                if st3 == "found":
                    return st3, p3
                if st3 == "term":
                    return "term", possible
            if not after:
                return "term", possible
            possible = after
            continue
        if isinstance(stmt, ast.With):
            st, p = _scan(stmt.body, possible, site, var)
            if st != "fall":
                return st, p
            possible = p
            continue
        # plain statements can't contain a statement-level Assign
    return "fall", possible


def _from_states(func: ast.AST, site: ast.Assign, var: str) -> FrozenSet[str]:
    body = getattr(func, "body", None)
    if body is None:
        return _STATES
    st, p = _scan(body, _STATES, site, var)
    return p if st == "found" else _STATES


# ------------------------------------------------------- the four checks
def extract_block_transitions(
        files: Sequence[SourceFile]
) -> Tuple[List[Finding], Set[Tuple[str, str]]]:
    """(findings, observed (from, to) pairs) for the block lifecycle."""
    findings: List[Finding] = []
    observed: Set[Tuple[str, str]] = set()
    for sf in files:
        if not sf.in_repro:
            continue
        add_parents(sf.tree)
        for node in ast.walk(sf.tree):
            if not (isinstance(node, ast.Assign) and len(node.targets) == 1):
                continue
            var = _is_state_lvalue(node.targets[0])
            dst = _state_literal(node.value)
            if var is None or dst is None:
                continue
            func = enclosing_function(node)
            qn = qualname_of(node)
            if func is not None and getattr(func, "name", "") == "__init__" \
                    and var == "self":
                if dst != BLOCK.initial:
                    findings.append(Finding(
                        "conf-transition", sf.rel, node.lineno,
                        f"{qn}: lifecycle starts in {dst}, spec initial "
                        f"state is {BLOCK.initial}"))
                continue
            srcs = _from_states(func, node, var) if func is not None \
                else _STATES
            for src in sorted(srcs):
                observed.add((src, dst))
                if not BLOCK.allows(src, dst):
                    findings.append(Finding(
                        "conf-transition", sf.rel, node.lineno,
                        f"{qn}: possible transition {src} -> {dst} is not "
                        f"in the block lifecycle spec — guard the write "
                        f"(or extend specs.BLOCK if the protocol changed)"))
    return findings, observed


def _enum_members(files: Sequence[SourceFile]) -> Set[str]:
    members: Set[str] = set()
    for sf in files:
        if not sf.in_repro:
            continue
        for node in ast.walk(sf.tree):
            if not isinstance(node, ast.ClassDef):
                continue
            if not any("Enum" in dotted_name(b) for b in node.bases):
                continue
            for stmt in node.body:
                if isinstance(stmt, ast.Assign):
                    for t in stmt.targets:
                        if isinstance(t, ast.Name):
                            members.add(t.id)
    return members


def check_state_names(files: Sequence[SourceFile]) -> List[Finding]:
    universe = _enum_members(files)
    out: List[Finding] = []
    for sf in files:
        if not sf.in_repro:
            continue
        for node in ast.walk(sf.tree):
            if not (isinstance(node, ast.Compare) and len(node.ops) == 1):
                continue
            left = node.left
            if not (isinstance(left, ast.Attribute) and left.attr == "name"
                    and isinstance(left.value, ast.Attribute)
                    and left.value.attr == "state"):
                continue
            right = node.comparators[0]
            literals: Iterable[ast.AST] = (
                right.elts if isinstance(right, (ast.Tuple, ast.List,
                                                 ast.Set)) else [right])
            for lit in literals:
                if isinstance(lit, ast.Constant) \
                        and isinstance(lit.value, str) \
                        and lit.value not in universe:
                    out.append(Finding(
                        "conf-state-name", sf.rel, node.lineno,
                        f".state.name compared against {lit.value!r}, "
                        f"which names no member of any declared enum"))
    return out


def _mutated_field(node: ast.AST) -> Optional[Tuple[str, str, int]]:
    """If ``node`` mutates ``<base>.<field>`` return (base-dotted-name,
    field, line): assignment, augmented assignment, del, subscript
    store, or a mutating method call."""
    def owner_of(attr: ast.AST) -> Optional[Tuple[str, str, int]]:
        if isinstance(attr, ast.Attribute):
            return dotted_name(attr.value), attr.attr, attr.lineno
        return None

    if isinstance(node, (ast.Assign, ast.AugAssign)):
        targets = node.targets if isinstance(node, ast.Assign) \
            else [node.target]
        for t in targets:
            if isinstance(t, ast.Subscript):
                t = t.value
            got = owner_of(t)
            if got:
                return got
    elif isinstance(node, ast.Delete):
        for t in node.targets:
            if isinstance(t, ast.Subscript):
                t = t.value
            got = owner_of(t)
            if got:
                return got
    elif isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) \
            and node.func.attr in _MUTATING_METHODS:
        return owner_of(node.func.value)
    return None


def _check_class_mutators(sf: SourceFile, cls_name: str,
                          fields: Dict[str, FrozenSet[str]],
                          lifecycle: str) -> List[Finding]:
    out: List[Finding] = []
    cls = next((n for n in ast.walk(sf.tree)
                if isinstance(n, ast.ClassDef) and n.name == cls_name), None)
    if cls is None:
        return [Finding("conf-mutator", sf.rel, 1,
                        f"class {cls_name} not found — the {lifecycle} "
                        f"mutator spec no longer matches the code")]
    for node in ast.walk(cls):
        got = _mutated_field(node)
        if got is None:
            continue
        base, field, line = got
        if field not in fields:
            continue
        # `self.<field>` inside the class, or a `<dom>.bank`-style slot
        # write (base is a local holding the owned record)
        func = enclosing_function(node)
        method = getattr(func, "name", "<module>") if func is not None \
            else "<module>"
        if method == "__init__" or method in fields[field]:
            continue
        out.append(Finding(
            "conf-mutator", sf.rel, line,
            f"{cls_name}.{method} mutates {lifecycle} state "
            f"{base}.{field} — only "
            f"{', '.join(sorted(fields[field]))} (and __init__) may"))
    return out


def _check_foreign_mutations(files: Sequence[SourceFile], owner_rel: str,
                             hint: str, fields: Dict[str, FrozenSet[str]],
                             lifecycle: str) -> List[Finding]:
    """No file other than the owner may mutate ``*.<hint>.<field>``."""
    out: List[Finding] = []
    for sf in files:
        if not sf.in_repro or sf.rel == owner_rel \
                or sf.rel.startswith("src/repro_torch/lint/"):
            continue
        for node in ast.walk(sf.tree):
            got = _mutated_field(node)
            if got is None:
                continue
            base, field, line = got
            if field in fields and (base == hint
                                    or base.endswith("." + hint)):
                out.append(Finding(
                    "conf-mutator", sf.rel, line,
                    f"{lifecycle} state {base}.{field} mutated outside "
                    f"{owner_rel} — route through the owning scheduler"))
    return out


def check_mutators(files: Sequence[SourceFile]) -> List[Finding]:
    out: List[Finding] = []
    for sf in files:
        if sf.rel == "src/repro_torch/core/node.py":
            out += _check_class_mutators(sf, "R5Scheduler", TR_ID_FIELDS,
                                         "tr_id")
        elif sf.rel == "src/repro_torch/tenancy/banks.py":
            out += _check_class_mutators(sf, "BankManager", BANK_FIELDS,
                                         "bank")
    out += _check_foreign_mutations(files, "src/repro_torch/core/node.py", "r5",
                                    TR_ID_FIELDS, "tr_id")
    out += _check_foreign_mutations(files, "src/repro_torch/tenancy/banks.py",
                                    "banks", BANK_FIELDS, "bank")
    return out


def check_statuses(files: Sequence[SourceFile]) -> List[Finding]:
    out: List[Finding] = []
    errors = set(WC_ERROR_STATUSES)
    for sf in files:
        if not sf.in_repro:
            continue
        add_parents(sf.tree)
        for node in ast.walk(sf.tree):
            # ---- fail_transfer(transfer, <status>) call sites
            if isinstance(node, ast.Call) \
                    and call_name(node).endswith("fail_transfer") \
                    and not isinstance(parent(node), ast.FunctionDef):
                status = node.args[1] if len(node.args) > 1 else next(
                    (k.value for k in node.keywords if k.arg == "status"),
                    None)
                if status is None:
                    continue
                if isinstance(status, ast.Constant):
                    if status.value not in errors:
                        out.append(Finding(
                            "conf-status", sf.rel, node.lineno,
                            f"fail_transfer called with status "
                            f"{status.value!r} — spec allows "
                            f"{sorted(errors)}"))
                elif not (isinstance(status, ast.Call)
                          and call_name(status).endswith("_crash_status")):
                    out.append(Finding(
                        "conf-status", sf.rel, node.lineno,
                        "fail_transfer status is neither a spec'd "
                        "literal nor _crash_status(...) — the checker "
                        "cannot prove it is a legal WC status"))
            # ---- _crash_status return literals
            if isinstance(node, ast.FunctionDef) \
                    and node.name == "_crash_status":
                for ret in ast.walk(node):
                    if isinstance(ret, ast.Return) and ret.value is not None:
                        for c in ast.walk(ret.value):
                            if isinstance(c, ast.Constant) \
                                    and isinstance(c.value, str) \
                                    and c.value not in errors:
                                out.append(Finding(
                                    "conf-status", sf.rel, ret.lineno,
                                    f"_crash_status can return "
                                    f"{c.value!r}, not a spec'd WC error "
                                    f"status"))
        # ---- WCStatus enum mirrors the spec
        if sf.rel == "src/repro_torch/api/completion.py":
            out += _check_wcstatus_enum(sf)
        # ---- invariants.FAILED_STATUSES mirrors the spec
        if sf.rel == "src/repro_torch/testing/invariants.py":
            out += _check_failed_statuses(sf)
        # ---- fail_transfer leads with the exactly-once guard
        if sf.rel == "src/repro_torch/core/node.py":
            out += _check_exactly_once_guard(sf)
    return out


def _check_wcstatus_enum(sf: SourceFile) -> List[Finding]:
    want = {WC_SUCCESS} | set(WC_ERROR_STATUSES)
    cls = next((n for n in ast.walk(sf.tree)
                if isinstance(n, ast.ClassDef) and n.name == "WCStatus"),
               None)
    if cls is None:
        return [Finding("conf-status", sf.rel, 1,
                        "WCStatus enum not found in api/completion.py")]
    got = {}
    for stmt in cls.body:
        if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 \
                and isinstance(stmt.targets[0], ast.Name) \
                and isinstance(stmt.value, ast.Constant) \
                and isinstance(stmt.value.value, str):
            got[stmt.targets[0].id] = stmt.value.value
    out = []
    if set(got.values()) != want:
        out.append(Finding(
            "conf-status", sf.rel, cls.lineno,
            f"WCStatus values {sorted(got.values())} != spec "
            f"{sorted(want)}"))
    for name, value in sorted(got.items()):
        if name != value.upper():
            out.append(Finding(
                "conf-status", sf.rel, cls.lineno,
                f"WCStatus.{name} = {value!r}: member name must be the "
                f"uppercased wire string"))
    return out


def _check_failed_statuses(sf: SourceFile) -> List[Finding]:
    for node in ast.walk(sf.tree):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name) \
                and node.targets[0].id == "FAILED_STATUSES":
            if isinstance(node.value, ast.Set):
                got = {e.value for e in node.value.elts
                       if isinstance(e, ast.Constant)}
                if got != set(WC_ERROR_STATUSES):
                    return [Finding(
                        "conf-status", sf.rel, node.lineno,
                        f"invariants.FAILED_STATUSES {sorted(got)} != "
                        f"spec {sorted(WC_ERROR_STATUSES)}")]
            return []
    return [Finding("conf-status", sf.rel, 1,
                    "invariants.FAILED_STATUSES not found")]


def _check_exactly_once_guard(sf: SourceFile) -> List[Finding]:
    fn = next((n for n in ast.walk(sf.tree)
               if isinstance(n, ast.FunctionDef)
               and n.name == "fail_transfer"), None)
    if fn is None:
        return [Finding("conf-status", sf.rel, 1,
                        "R5Scheduler.fail_transfer not found")]
    body = [s for s in fn.body
            if not (isinstance(s, ast.Expr)
                    and isinstance(s.value, ast.Constant))]   # skip docstring
    ok = False
    if body and isinstance(body[0], ast.If) \
            and body[0].body and isinstance(body[0].body[0], ast.Return):
        names = {n.attr for n in ast.walk(body[0].test)
                 if isinstance(n, ast.Attribute)}
        ok = {"failed_status", "complete"} <= names
    if not ok:
        return [Finding(
            "conf-status", sf.rel, fn.lineno,
            "fail_transfer must START with the exactly-once guard "
            "(return if failed_status is set or the transfer completed) "
            "— anything before it can run twice")]
    return []


def run(files: Sequence[SourceFile]) -> List[Finding]:
    findings, _ = extract_block_transitions(files)
    findings += check_state_names(files)
    findings += check_mutators(files)
    findings += check_statuses(files)
    return findings
