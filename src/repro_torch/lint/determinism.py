"""Determinism linter: AST rules over ``src/repro_torch/``.

The simulator's contract is byte-identical soak stats per seed
(``SoakResult.json()``).  Anything that lets *incidental* order — hash
randomization, wall-clock, object addresses, heap ties — leak into event
order or stats breaks that contract, usually long after the commit that
planted it.  These rules flag the known hazard shapes:

``det-set-iter``
    Iterating a set (literal, comprehension, ``set()``/``frozenset()``
    call, set algebra) in an order-sensitive position.  String hashes are
    randomized per process; object hashes are addresses.
``det-dict-iter``
    Iterating ``.keys()``/``.values()``/``.items()`` in an
    order-sensitive position in an event-path module.  Insertion order
    *is* deterministic, which is exactly why unsorted dict iteration
    passes every test until a refactor reorders the insertions — the
    rule enforces ``sorted(...)`` (or an order-insensitive consumer) so
    the event path never depends on insertion history.
``det-wallclock``
    ``time.time``/``monotonic``/``perf_counter``, ``datetime.now`` etc.
``det-unseeded-random``
    Module-level ``random.*`` / ``numpy.random.*`` (the process-global,
    implicitly-seeded generators).  Seeded ``random.Random(seed)``
    instances and key-passing ``jax.random`` are fine.
``det-id-order``
    ``id(...)`` used as a key/ordering token in an event-path module.
    CPython reuses addresses after GC, so two live-at-different-times
    objects can compare equal.  Equality-only dedup against a set of
    live objects is exempt.
``det-heap-tiebreak``
    ``heapq.heappush`` of a key that can compare equal without a unique
    tiebreaker (the loop's ``(time, seq, event)`` shape is the good
    example: ``seq`` is unique, so ties never reach the event compare).

Order-*insensitive* consumers are exempt everywhere: ``sorted``, ``min``,
``max``, ``sum``, ``len``, ``any``, ``all``, ``set``, ``frozenset``,
membership tests, and set-building comprehensions.
"""

from __future__ import annotations

import ast
from typing import Iterator, List, Optional, Sequence, Set, Tuple

from repro_torch.lint.common import (Finding, SourceFile, add_parents, call_name,
                               dotted_name, parent)

#: callables whose result does not depend on argument iteration order
ORDER_INSENSITIVE_CALLS = {
    "sorted", "min", "max", "sum", "len", "any", "all", "set", "frozenset",
}

_WALLCLOCK = {
    "time.time", "time.time_ns", "time.monotonic", "time.monotonic_ns",
    "time.perf_counter", "time.perf_counter_ns", "datetime.now",
    "datetime.utcnow", "datetime.today", "date.today",
    "datetime.datetime.now", "datetime.datetime.utcnow",
}

_GLOBAL_RANDOM = {
    "random", "randint", "randrange", "choice", "choices", "shuffle",
    "sample", "uniform", "gauss", "normalvariate", "getrandbits",
    "betavariate", "expovariate", "triangular", "vonmisesvariate",
}

_SET_ALGEBRA_METHODS = {"union", "intersection", "difference",
                        "symmetric_difference"}

_MUTATOR_EXEMPT_METHODS = {"add", "discard", "remove", "update"}


def _is_setlike(node: ast.AST) -> bool:
    if isinstance(node, (ast.Set, ast.SetComp)):
        return True
    if isinstance(node, ast.Call):
        name = call_name(node)
        if name in ("set", "frozenset"):
            return True
        if isinstance(node.func, ast.Attribute) \
                and node.func.attr in _SET_ALGEBRA_METHODS:
            return True
    if isinstance(node, ast.BinOp) and isinstance(
            node.op, (ast.BitOr, ast.BitAnd, ast.Sub, ast.BitXor)):
        return _is_setlike(node.left) or _is_setlike(node.right)
    return False


def _is_dict_view(node: ast.AST) -> bool:
    return (isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr in ("keys", "values", "items")
            and not node.args and not node.keywords)


def _consumer_is_order_insensitive(node: ast.AST) -> bool:
    """Walk outward from an iterable expression: is everything between it
    and its consumer order-insensitive?"""
    cur, up = node, parent(node)
    while up is not None:
        if isinstance(up, ast.Call) and cur in up.args:
            name = call_name(up)
            if name in ORDER_INSENSITIVE_CALLS:
                return True
            if isinstance(up.func, ast.Attribute) \
                    and up.func.attr in ("update", "union", "intersection",
                                         "difference", "issubset",
                                         "issuperset", "isdisjoint"):
                # set/dict .update() and set algebra are order-insensitive
                # (dict.update is insertion-order preserving — the callee
                # dict's determinism is its own iteration's concern)
                return True
            return False
        if isinstance(up, ast.Compare) and cur in up.comparators \
                and all(isinstance(op, (ast.In, ast.NotIn)) for op in up.ops):
            return True                      # membership test
        if isinstance(up, ast.comprehension):
            # ``cur`` is the .iter of a comprehension clause; the consumer
            # of the produced elements is the comprehension expression
            comp = parent(up)
            if isinstance(comp, (ast.SetComp, ast.DictComp)):
                # building a set/dict: the *result* is order-free (sets)
                # or will face this rule at ITS consumption site (dicts
                # rebuilt key-by-value keep determinism questions local)
                return True
            cur, up = comp, parent(comp)     # genexp/listcomp: its consumer
            continue
        if isinstance(up, (ast.SetComp, ast.DictComp)):
            return True
        if isinstance(up, (ast.GeneratorExp, ast.ListComp)):
            cur, up = up, parent(up)         # look at the lazy consumer
            continue
        if isinstance(up, ast.For):
            return False                     # plain ordered loop
        if isinstance(up, ast.Starred):
            cur, up = up, parent(up)
            continue
        return False
    return False


def _iteration_sites(tree: ast.AST) -> "Iterator[Tuple[ast.expr, int]]":
    """Yield (iter_expr, line) for every ordered-iteration position."""
    for node in ast.walk(tree):
        if isinstance(node, ast.For):
            yield node.iter, node.lineno
        elif isinstance(node, (ast.ListComp, ast.SetComp, ast.DictComp,
                               ast.GeneratorExp)):
            for comp in node.generators:
                yield comp.iter, getattr(comp.iter, "lineno", node.lineno)
        elif isinstance(node, ast.Call) and call_name(node) in (
                "list", "tuple", "enumerate", "reversed"):
            for arg in node.args[:1]:
                yield arg, getattr(arg, "lineno", node.lineno)


def _check_set_and_dict_iter(sf: SourceFile) -> List[Finding]:
    out = []
    for expr, line in _iteration_sites(sf.tree):
        if _is_setlike(expr):
            target = expr
        elif sf.in_event_path and _is_dict_view(expr):
            target = expr
        else:
            continue
        if _consumer_is_order_insensitive(target):
            continue
        rule = "det-set-iter" if _is_setlike(target) else "det-dict-iter"
        what = ("a set" if rule == "det-set-iter"
                else f"dict .{target.func.attr}()")       # type: ignore
        out.append(Finding(
            rule, sf.rel, line,
            f"iteration over {what} in an order-sensitive position — "
            f"wrap in sorted(...) or consume order-insensitively"))
    return out


def _check_wallclock(sf: SourceFile) -> List[Finding]:
    out = []
    for node in ast.walk(sf.tree):
        if isinstance(node, ast.Attribute):
            name = dotted_name(node)
            if name in _WALLCLOCK:
                out.append(Finding(
                    "det-wallclock", sf.rel, node.lineno,
                    f"wall-clock read {name}() — simulated components "
                    f"must use EventLoop.now (virtual time)"))
    return out


def _check_unseeded_random(sf: SourceFile) -> List[Finding]:
    out = []
    for node in ast.walk(sf.tree):
        if not isinstance(node, ast.Attribute):
            continue
        name = dotted_name(node)
        base, _, attr = name.rpartition(".")
        if base == "random" and attr in _GLOBAL_RANDOM:
            out.append(Finding(
                "det-unseeded-random", sf.rel, node.lineno,
                f"module-level random.{attr} uses the process-global "
                f"generator — pass a seeded random.Random instance"))
        elif base in ("np.random", "numpy.random") \
                and attr not in ("default_rng", "Generator", "SeedSequence"):
            out.append(Finding(
                "det-unseeded-random", sf.rel, node.lineno,
                f"global numpy random {name} — use "
                f"np.random.default_rng(seed)"))
    return out


def _check_id_order(sf: SourceFile) -> List[Finding]:
    out = []
    for node in ast.walk(sf.tree):
        if not (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
                and node.func.id == "id" and len(node.args) == 1):
            continue
        up = parent(node)
        # equality-only dedup is safe while the objects stay live: id()
        # membership tests and set.add/discard/remove never order anything
        if isinstance(up, ast.Compare) and all(
                isinstance(op, (ast.Eq, ast.NotEq, ast.In, ast.NotIn, ast.Is,
                                ast.IsNot))
                for op in up.ops):
            continue
        if isinstance(up, ast.Call) and isinstance(up.func, ast.Attribute) \
                and up.func.attr in _MUTATOR_EXEMPT_METHODS:
            continue
        out.append(Finding(
            "det-id-order", sf.rel, node.lineno,
            "id(...) used as a key/ordering token — CPython reuses "
            "addresses after GC; derive a stable key from the object's "
            "own identity (tid, index, node_id, ...)"))
    return out


def _names_assigned_from(func: Optional[ast.AST],
                         callees: Sequence[str]) -> Set[str]:
    """Names bound (anywhere in ``func``) from a call to one of
    ``callees`` — e.g. ``seq = next(...)``, ``entry = heapq.heappop(h)``."""
    if func is None:
        return set()
    names: Set[str] = set()
    for node in ast.walk(func):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call) \
                and call_name(node.value) in callees:
            for tgt in node.targets:
                if isinstance(tgt, ast.Name):
                    names.add(tgt.id)
    return names


def _has_unique_tiebreak(item: ast.AST, func: Optional[ast.AST]) -> bool:
    if isinstance(item, ast.Name) and item.id in _names_assigned_from(
            func, ("heapq.heappop", "heappop")):
        return True        # re-pushing an entry that was already well-formed
    if not isinstance(item, ast.Tuple):
        return False
    next_names = _names_assigned_from(func, ("next",))
    for el in item.elts:
        if isinstance(el, ast.Call) and call_name(el) == "next":
            return True
        name = el.id if isinstance(el, ast.Name) else (
            el.attr if isinstance(el, ast.Attribute) else "")
        if name in next_names or "seq" in name or "counter" in name:
            return True
    return False


def _check_heap_tiebreak(sf: SourceFile) -> List[Finding]:
    out = []
    from repro_torch.lint.common import enclosing_function
    for node in ast.walk(sf.tree):
        if not (isinstance(node, ast.Call)
                and call_name(node) in ("heapq.heappush", "heappush")
                and len(node.args) == 2):
            continue
        item = node.args[1]
        if _has_unique_tiebreak(item, enclosing_function(node)):
            continue
        out.append(Finding(
            "det-heap-tiebreak", sf.rel, node.lineno,
            "heap push without a unique tiebreaker — equal keys fall "
            "back to object comparison (or raise); push "
            "(key, next(counter), payload) tuples"))
    return out


def run(files: Sequence[SourceFile]) -> List[Finding]:
    """All determinism rules over every ``src/repro_torch/`` file given."""
    out: List[Finding] = []
    for sf in files:
        if not sf.in_repro:
            continue
        add_parents(sf.tree)
        out += _check_set_and_dict_iter(sf)
        out += _check_wallclock(sf)
        out += _check_unseeded_random(sf)
        if sf.in_event_path:
            out += _check_id_order(sf)
        out += _check_heap_tiebreak(sf)
    return out
