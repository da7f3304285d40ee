"""``typed-raise``: no bare builtin exceptions at the API surface.

``repro_torch.api`` and ``repro_torch.tenancy`` are what callers program against,
and callers discriminate failures by type (``except DomainClosed``,
``pytest.raises(ConfigError)``).  A bare ``raise ValueError(...)`` there
forces string matching on the caller.  The typed hierarchy lives in
``repro_torch.errors``; every class subclasses ``ValueError`` or
``RuntimeError`` so legacy ``except ValueError`` call sites keep
working — which is also why this rule exists: nothing else would stop
a bare raise from creeping back in.

``TypeError`` stays allowed — passing the wrong *kind* of object is a
programming error, and the stdlib idiom is correct for it.  Re-raises
(``raise`` with no operand) and raises of locally-caught names are
out of scope.
"""

from __future__ import annotations

import ast
from typing import List, Sequence

from repro_torch.lint.common import Finding, SourceFile

BANNED = ("ValueError", "RuntimeError", "Exception")

SCOPE = ("src/repro_torch/api/", "src/repro_torch/tenancy/")


def run(files: Sequence[SourceFile]) -> List[Finding]:
    out: List[Finding] = []
    for sf in files:
        if not sf.rel.startswith(SCOPE):
            continue
        for node in ast.walk(sf.tree):
            if not isinstance(node, ast.Raise) or node.exc is None:
                continue
            exc = node.exc
            name = ""
            if isinstance(exc, ast.Call) and isinstance(exc.func, ast.Name):
                name = exc.func.id
            elif isinstance(exc, ast.Name):
                name = exc.id
            if name in BANNED:
                out.append(Finding(
                    "typed-raise", sf.rel, node.lineno,
                    f"bare {name} raised at the API surface — raise a "
                    f"typed error from repro_torch.errors (they subclass "
                    f"{name if name != 'Exception' else 'ValueError'}, "
                    f"so existing handlers keep working)"))
    return out
