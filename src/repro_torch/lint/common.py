"""Shared plumbing for the ``repro_torch.lint`` passes.

A *pass* is a function ``(files: Sequence[SourceFile]) -> list[Finding]``.
Passes never print and never consult suppressions — the CLI applies the
``# torch-lint: allow(<rule>)`` comments afterwards, so the same pass code
serves both the build gate and the fixture tests in ``tests/test_lint.py``.

Suppression syntax (same line as the finding, or the line above)::

    foo = time.time()   # torch-lint: allow(<rule-id>): host telemetry only

The justification after the ``:``/``—`` is mandatory: an allow() with no
stated reason is itself a finding (``lint-suppression``), and so is an
allow() naming an unknown rule or one that suppresses nothing
(``lint-unused-suppression``) — suppressions cannot rot silently.
"""

from __future__ import annotations

import ast
import dataclasses
import re
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

#: every rule id a suppression may name (passes register theirs here)
KNOWN_RULES = (
    "det-set-iter",
    "det-dict-iter",
    "det-wallclock",
    "det-unseeded-random",
    "det-id-order",
    "det-heap-tiebreak",
    "typed-raise",
    "stats-coverage",
    "conf-transition",
    "conf-state-name",
    "conf-mutator",
    "conf-status",
    "conf-model",
    "lint-suppression",
    "lint-unused-suppression",
)

_SUPPRESS_RE = re.compile(
    r"#\s*torch-lint:\s*allow\(\s*([A-Za-z0-9_,\- ]+?)\s*\)\s*(?:[:—-]\s*(.*))?$")

#: directories (under src/repro) on the deterministic event path — the
#: modules whose iteration order feeds simulated time and soak stats
EVENT_PATH_DIRS = ("core", "net", "npr", "tenancy", "vmem", "api")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One diagnostic: rule id, location, human-readable message."""

    rule: str
    path: str          # repo-relative, forward slashes
    line: int
    message: str

    def render(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"


@dataclasses.dataclass
class Suppression:
    line: int
    rules: Tuple[str, ...]
    justification: str
    used: bool = False


class SourceFile:
    """One parsed Python file plus its suppression comments."""

    def __init__(self, rel: str, text: str) -> None:
        self.rel = rel.replace("\\", "/")
        self.text = text
        self.lines = text.splitlines()
        self.tree = ast.parse(text, filename=rel)
        self.suppressions: Dict[int, Suppression] = {}
        for i, line in enumerate(self.lines, start=1):
            m = _SUPPRESS_RE.search(line)
            if m is None:
                continue
            rules = tuple(r.strip() for r in m.group(1).split(",") if r.strip())
            just = (m.group(2) or "").strip()
            self.suppressions[i] = Suppression(i, rules, just)

    @classmethod
    def load(cls, path: Path, root: Path) -> "SourceFile":
        rel = str(path.relative_to(root))
        return cls(rel, path.read_text(encoding="utf-8"))

    # ------------------------------------------------------------- scoping
    @property
    def in_repro(self) -> bool:
        return self.rel.startswith("src/repro_torch/")

    @property
    def in_event_path(self) -> bool:
        return any(self.rel.startswith(f"src/repro_torch/{d}/")
                   for d in EVENT_PATH_DIRS)

    # -------------------------------------------------------- suppressions
    def is_suppressed(self, rule: str, line: int) -> bool:
        """True (and marks the comment used) if an allow() covers
        ``rule`` on ``line`` or on the line above it."""
        for cand in (line, line - 1):
            sup = self.suppressions.get(cand)
            if sup is not None and rule in sup.rules:
                sup.used = True
                return True
        return False

    def hygiene_findings(self) -> List[Finding]:
        """Malformed suppressions: unknown rule ids, missing reasons."""
        out = []
        for sup in self.suppressions.values():
            for rule in sup.rules:
                if rule not in KNOWN_RULES:
                    out.append(Finding(
                        "lint-suppression", self.rel, sup.line,
                        f"allow() names unknown rule {rule!r}"))
            if not sup.justification:
                out.append(Finding(
                    "lint-suppression", self.rel, sup.line,
                    "allow() without a justification — state why the "
                    "finding is deliberate after a ':'"))
        return out

    def unused_suppression_findings(self) -> List[Finding]:
        """Call after every pass ran + suppressions were applied."""
        return [Finding("lint-unused-suppression", self.rel, sup.line,
                        f"allow({', '.join(sup.rules)}) suppresses nothing "
                        f"on this line — remove it")
                for sup in self.suppressions.values() if not sup.used]


def collect_files(paths: Sequence[str], root: Path) -> List[SourceFile]:
    """Every ``.py`` file under the given repo-relative paths, sorted."""
    seen: Dict[str, SourceFile] = {}
    for arg in paths:
        p = (root / arg).resolve()
        candidates: Iterable[Path]
        if p.is_file() and p.suffix == ".py":
            candidates = [p]
        elif p.is_dir():
            candidates = sorted(q for q in p.rglob("*.py")
                                if "__pycache__" not in q.parts)
        else:
            continue
        for q in candidates:
            sf = SourceFile.load(q, root)
            seen.setdefault(sf.rel, sf)
    return [seen[k] for k in sorted(seen)]


# --------------------------------------------------------------- AST utils
def add_parents(tree: ast.AST) -> None:
    """Annotate every node with ``.lint_parent`` (None at the root)."""
    tree.lint_parent = None                    # type: ignore[attr-defined]
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            child.lint_parent = node           # type: ignore[attr-defined]


def parent(node: ast.AST) -> Optional[ast.AST]:
    return getattr(node, "lint_parent", None)


def enclosing_function(node: ast.AST) -> Optional[ast.AST]:
    cur = parent(node)
    while cur is not None:
        if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return cur
        cur = parent(cur)
    return None


def qualname_of(node: ast.AST) -> str:
    """``Class.method`` / ``function`` for the scope containing ``node``."""
    names: List[str] = []
    cur: Optional[ast.AST] = node
    while cur is not None:
        if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef,
                            ast.ClassDef)):
            names.append(cur.name)
        cur = parent(cur)
    return ".".join(reversed(names)) or "<module>"


def call_name(node: ast.Call) -> str:
    """Dotted name of a call target, best effort (``heapq.heappush``)."""
    return dotted_name(node.func)


def dotted_name(node: ast.AST) -> str:
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        base = dotted_name(node.value)
        return f"{base}.{node.attr}" if base else node.attr
    return ""
