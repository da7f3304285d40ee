"""``python -m repro_torch.lint [paths...]`` — the build gate.

Runs every static pass (determinism, typed errors, stats coverage,
protocol conformance, spec model check) over the given paths, applies
``torch-lint: allow(<rule>): <reason>`` comment suppressions, and exits
non-zero on any
unsuppressed finding.  Pure stdlib: CI and pre-commit can run it with
no environment beyond ``PYTHONPATH=src``.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path
from typing import List

from repro_torch.lint import (common, conformance, determinism, model,
                        stats_coverage, typed_errors)
from repro_torch.lint.common import Finding, SourceFile, collect_files

#: passes, in report order; all share the (files) -> findings shape
PASSES = (
    ("determinism", determinism.run),
    ("typed-errors", typed_errors.run),
    ("stats-coverage", stats_coverage.run),
    ("conformance", conformance.run),
)


def lint(files: List[SourceFile], with_model: bool = True) -> List[Finding]:
    """All passes + suppression handling; returns unsuppressed findings."""
    findings: List[Finding] = []
    for _, fn in PASSES:
        findings.extend(fn(files))
    by_rel = {sf.rel: sf for sf in files}
    kept = []
    for f in findings:
        sf = by_rel.get(f.path)
        if sf is not None and sf.is_suppressed(f.rule, f.line):
            continue
        kept.append(f)
    if with_model:
        kept.extend(model.run())                  # specs are not in files
    for sf in files:
        kept.extend(sf.hygiene_findings())
        kept.extend(sf.unused_suppression_findings())
    kept.sort(key=lambda f: (f.path, f.line, f.rule, f.message))
    return kept


def main(argv: List[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="repro_torch.lint",
        description="protocol-conformance + determinism static analysis")
    ap.add_argument("paths", nargs="*", default=["src"],
                    help="files/directories to lint (repo-relative)")
    ap.add_argument("--root", default=".",
                    help="repository root (default: cwd)")
    ap.add_argument("--no-model", action="store_true",
                    help="skip the spec model checker")
    ap.add_argument("-q", "--quiet", action="store_true",
                    help="findings only, no summary")
    args = ap.parse_args(argv)

    root = Path(args.root).resolve()
    files = collect_files(args.paths or ["src"], root)
    if not files:
        print(f"repro_torch.lint: no Python files under {args.paths}",
              file=sys.stderr)
        return 2

    findings = lint(files, with_model=not args.no_model)
    for f in findings:
        print(f.render())

    if not args.quiet:
        suppressed = sum(
            1 for sf in files for sup in sf.suppressions.values()
            if sup.used)
        _, observed = conformance.extract_block_transitions(files)
        mres = None if args.no_model else model.check_model()
        print(f"repro_torch.lint: {len(files)} files, "
              f"{len(common.KNOWN_RULES)} rules, "
              f"{len(findings)} findings, {suppressed} suppressed",
              file=sys.stderr)
        print(f"repro_torch.lint: conformance extracted "
              f"{len(observed)}/{len(conformance.BLOCK.transitions)} block "
              f"transitions across 4 lifecycles"
              + ("" if mres is None else
                 f"; model explored {mres.states_explored} states over "
                 f"{len(model.scenarios())} scenarios"),
              file=sys.stderr)
    return 1 if findings else 0


if __name__ == "__main__":                        # pragma: no cover
    sys.exit(main())
