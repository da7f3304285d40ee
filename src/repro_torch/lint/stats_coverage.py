"""``stats-coverage``: every telemetry counter is checked or exempted.

The soak harness regresses on ``*Stats`` counters, so a counter that
silently stops moving (or double-counts) is a bug the test suite can't
see unless some invariant reads it.  This pass cross-references:

* **counters** — class-level ``field: int``/``float`` annotations on
  every class named ``*Stats`` under ``src/repro_torch/``;
* **checked** — attribute names read anywhere in
  ``src/repro_torch/testing/invariants.py``, plus the members of a class's
  ``ADDITIVE`` tuple when the invariants access ``Cls.ADDITIVE``
  (the additive-sum checkers iterate it with ``getattr``);
* **exempt** — :data:`repro_torch.lint.specs.STATS_EXEMPT` rows, each with a
  stated reason (``"*"`` covers a whole telemetry-only class).

Coverage is by *field name*, not by class: a name read by any checker
counts everywhere it appears.  That coarseness only ever errs toward
silence, and the stale/redundant-exemption findings below keep the
exemption table from absorbing the slack:

* a row naming a field that no longer exists → the table rotted;
* a row naming a field the invariants DO read → the row is dead weight.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Sequence, Set, Tuple

from repro_torch.lint.common import Finding, SourceFile
from repro_torch.lint.specs import STATS_EXEMPT

INVARIANTS_PATH = "src/repro_torch/testing/invariants.py"


def _counter_fields(sf: SourceFile) -> List[Tuple[str, str, int]]:
    """(class, field, line) for every int/float counter annotation."""
    out = []
    for node in ast.walk(sf.tree):
        if not (isinstance(node, ast.ClassDef)
                and node.name.endswith("Stats")):
            continue
        for stmt in node.body:
            if isinstance(stmt, ast.AnnAssign) \
                    and isinstance(stmt.target, ast.Name) \
                    and isinstance(stmt.annotation, ast.Name) \
                    and stmt.annotation.id in ("int", "float"):
                out.append((node.name, stmt.target.id, stmt.lineno))
    return out


def _additive_members(sf: SourceFile) -> Dict[str, Set[str]]:
    """Class name -> members of its ``ADDITIVE`` tuple, if any."""
    out: Dict[str, Set[str]] = {}
    for node in ast.walk(sf.tree):
        if not isinstance(node, ast.ClassDef):
            continue
        for stmt in node.body:
            if isinstance(stmt, ast.Assign) \
                    and any(isinstance(t, ast.Name) and t.id == "ADDITIVE"
                            for t in stmt.targets) \
                    and isinstance(stmt.value, ast.Tuple):
                out[node.name] = {
                    e.value for e in stmt.value.elts
                    if isinstance(e, ast.Constant) and isinstance(e.value, str)
                }
    return out


def _checked_names(inv: SourceFile,
                   additive: Dict[str, Set[str]]) -> Set[str]:
    names: Set[str] = set()
    for node in ast.walk(inv.tree):
        if isinstance(node, ast.Attribute):
            names.add(node.attr)
            # `Cls.ADDITIVE` access pulls in that class's members
            if node.attr == "ADDITIVE" and isinstance(node.value, ast.Name):
                names |= additive.get(node.value.id, set())
    return names


def run(files: Sequence[SourceFile]) -> List[Finding]:
    inv = next((sf for sf in files if sf.rel == INVARIANTS_PATH), None)
    counters: List[Tuple[SourceFile, str, str, int]] = []
    additive: Dict[str, Set[str]] = {}
    for sf in files:
        if not sf.in_repro or sf.rel.startswith("src/repro_torch/lint/"):
            continue
        for cls, field, line in _counter_fields(sf):
            counters.append((sf, cls, field, line))
        additive.update(_additive_members(sf))
    if inv is None:
        # the CLI always passes src/; fixture runs may scope narrower
        return [] if not counters else [Finding(
            "stats-coverage", counters[0][0].rel, counters[0][3],
            f"{INVARIANTS_PATH} not in the scanned set — cannot prove "
            f"any counter is checked")]
    checked = _checked_names(inv, additive)

    out: List[Finding] = []
    by_class: Dict[str, Dict[str, int]] = {}
    for sf, cls, field, line in counters:
        by_class.setdefault(cls, {})[field] = line
        if field in checked:
            continue
        row = STATS_EXEMPT.get(cls, {})
        if field in row or "*" in row:
            continue
        out.append(Finding(
            "stats-coverage", sf.rel, line,
            f"{cls}.{field} is read by no invariant checker and carries "
            f"no exemption — add a check to testing/invariants.py or a "
            f"justified row to lint/specs.py:STATS_EXEMPT"))

    # exemption-table hygiene (findings anchor to the specs module)
    specs_rel = "src/repro_torch/lint/specs.py"
    for cls, rows in sorted(STATS_EXEMPT.items()):
        fields = by_class.get(cls)
        if fields is None:
            out.append(Finding(
                "stats-coverage", specs_rel, 1,
                f"STATS_EXEMPT names unknown stats class {cls!r}"))
            continue
        for field in sorted(rows):
            if field == "*":
                if all(f in checked for f in fields):
                    out.append(Finding(
                        "stats-coverage", specs_rel, 1,
                        f"STATS_EXEMPT[{cls!r}] wildcard is redundant — "
                        f"every field is checked by the invariants"))
                continue
            if field not in fields:
                out.append(Finding(
                    "stats-coverage", specs_rel, 1,
                    f"STATS_EXEMPT[{cls!r}] names missing field "
                    f"{field!r} — stale exemption"))
            elif field in checked:
                out.append(Finding(
                    "stats-coverage", specs_rel, 1,
                    f"STATS_EXEMPT[{cls!r}][{field!r}] is redundant — "
                    f"the invariants read this field"))
    return out
