"""``repro_torch.lint`` — protocol conformance + determinism static analysis.

Three layers guard the simulator's two core contracts (byte-identical
determinism per seed, and protocol behaviour that matches the paper's
fault-handling state machines):

* **static passes** (``determinism``, ``typed_errors``,
  ``stats_coverage``, ``conformance``) — pure-stdlib AST analysis run
  by ``python -m repro_torch.lint`` as a blocking CI gate;
* **spec model checker** (``model``) — exhaustively walks the product
  of the four lifecycle specs in ``specs.py`` across every fault ×
  budget × crash × steal scenario;
* **race sanitizer** (``race``) — opt-in EventLoop instrumentation
  (``FabricConfig(race_check=True)``) that reports same-timestamp
  event pairs whose relative order is load-bearing.

The specs in :mod:`repro_torch.lint.specs` are the single source of truth;
the README lifecycle tables render them and the conformance pass holds
the implementation to them.
"""

from repro_torch.lint.common import (KNOWN_RULES, Finding, SourceFile,
                               collect_files)
from repro_torch.lint.specs import ALL_SPECS, BANK, BLOCK, TR_ID, WR

__all__ = [
    "ALL_SPECS", "BANK", "BLOCK", "Finding", "KNOWN_RULES", "SourceFile",
    "TR_ID", "WR", "collect_files",
]
