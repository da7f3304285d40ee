"""Optimized-HLO analysis: FLOPs / bytes / collective bytes with loop
trip-count multiplication.

``compiled.cost_analysis()`` visits a while-loop body **once**, so a
scan-over-layers model under-reports by ~n_layers×.  The optimized HLO
text, however, annotates every while with ``known_trip_count`` — this
module parses the module into computations (building a per-computation
symbol table, since optimized HLO references operands by name), walks the
call graph from ENTRY multiplying multiplicities through ``while``
(× trip count) and ``fusion``/``call`` (× 1), and sums:

* **dot FLOPs** — 2 × out_elems × k from the dot's operand shapes
  (matmul-dominated models: this IS the FLOP count; elementwise FLOPs are
  O(bytes) and ignored, as in every MFU accounting);
* **collective bytes** — operand bytes of all-gather / all-reduce /
  reduce-scatter / all-to-all / collective-permute;
* **HBM bytes** — parameter + output bytes of top-level fusions, dots,
  copies and collectives at multiplicity (an estimate of HBM traffic
  under XLA's fusion).

The text analyzed comes from ``compiled.as_text()`` — post-GSPMD, so all
shapes are already **per-device**; sums are per-chip numbers directly.
"""

from __future__ import annotations

import dataclasses
import re
from collections import defaultdict
from typing import Optional

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "bf16": 2, "f16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8,
    "c64": 8, "c128": 16, "s4": 1, "u4": 1, "f8e4m3fn": 1, "f8e5m2": 1,
}

_SHAPE_RE = re.compile(r"\b([a-z][a-z0-9]*)\[([0-9,]*)\]")


def shape_bytes(shape_str: str) -> int:
    """Total bytes of a shape string (handles tuples)."""
    total = 0
    for m in _SHAPE_RE.finditer(shape_str):
        dt, dims = m.group(1), m.group(2)
        if dt not in _DTYPE_BYTES:
            continue
        n = 1
        if dims:
            for d in dims.split(","):
                n *= int(d)
        total += n * _DTYPE_BYTES[dt]
    return total


def shape_elems(shape_str: str) -> int:
    m = _SHAPE_RE.search(shape_str)
    if not m:
        return 0
    n = 1
    if m.group(2):
        for d in m.group(2).split(","):
            n *= int(d)
    return n


def shape_dims(shape_str: str) -> list:
    m = _SHAPE_RE.search(shape_str)
    if not m or not m.group(2):
        return []
    return [int(d) for d in m.group(2).split(",")]


@dataclasses.dataclass
class Instruction:
    name: str
    opcode: str
    out_shape: str
    operands: list                 # operand instruction names
    called: list                   # computation names invoked
    trip_count: int = 1
    raw: str = ""


@dataclasses.dataclass
class HLOAnalysis:
    dot_flops: float = 0.0
    collective_bytes: float = 0.0
    hbm_bytes: float = 0.0
    collective_breakdown: dict = dataclasses.field(default_factory=dict)
    dot_count: int = 0
    collective_count: int = 0
    computations: int = 0


_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")
_TRIP_RE = re.compile(r'known_trip_count"?[:=]\s*\{"?n"?:\s*"?(\d+)"?\}')
_CALLED_RE = re.compile(r"(?:condition|body|to_apply|calls)=%?([\w.\-]+)")
_BRANCHES_RE = re.compile(r"branch_computations=\{([^}]*)\}")
_INSTR_RE = re.compile(
    r"^(?:ROOT\s+)?%([\w.\-]+)\s*=\s*"
    r"((?:\([^)]*\))|(?:[a-z][a-z0-9]*\[[0-9,]*\](?:\{[^}]*\})?))\s*"
    r"([\w\-]+)\((.*)$")
_CONTRACT_RE = re.compile(r"lhs_contracting_dims=\{([0-9,]*)\}")
_OPERAND_RE = re.compile(r"%([\w.\-]+)")


def _parse_instruction(line: str) -> Optional[Instruction]:
    m = _INSTR_RE.match(line)
    if not m:
        return None
    name, out_shape, opcode, rest = m.groups()
    # operand names: inside the first balanced paren chunk
    depth = 1
    end = 0
    for i, ch in enumerate(rest):
        if ch == "(":
            depth += 1
        elif ch == ")":
            depth -= 1
            if depth == 0:
                end = i
                break
    args = rest[:end]
    attrs = rest[end + 1:]
    operands = _OPERAND_RE.findall(args)
    called = [c for c in _CALLED_RE.findall(attrs)]
    bm = _BRANCHES_RE.search(attrs)
    if bm:
        called += [c.strip().lstrip("%") for c in bm.group(1).split(",")]
    trip = 1
    tm = _TRIP_RE.search(attrs)
    if tm:
        trip = int(tm.group(1))
    return Instruction(name=name, opcode=opcode, out_shape=out_shape,
                       operands=operands, called=called, trip_count=trip,
                       raw=line)


def _parse_computations(hlo: str) -> tuple[dict, str]:
    comps: dict[str, list[Instruction]] = {}
    entry = None
    cur: Optional[str] = None
    for line in hlo.splitlines():
        s = line.strip()
        if s.endswith("{") and "->" in s and ("(" in s):
            header = s
            is_entry = header.startswith("ENTRY")
            if is_entry:
                header = header[len("ENTRY"):].strip()
            if not header.startswith("%") and not is_entry:
                # could be e.g. "HloModule ... {" — skip
                if not header.startswith("%"):
                    continue
            name = header.split()[0].split("(")[0].lstrip("%")
            cur = name
            comps[cur] = []
            if is_entry:
                entry = cur
        elif s.startswith("}"):
            cur = None
        elif cur is not None and "=" in s and s.lstrip().startswith(("%", "ROOT")):
            instr = _parse_instruction(s)
            if instr is not None:
                comps[cur].append(instr)
    return comps, entry or (next(iter(comps)) if comps else "")


def _dot_flops(instr: Instruction, symbols: dict) -> float:
    out_elems = shape_elems(instr.out_shape)
    cm = _CONTRACT_RE.search(instr.raw)
    if not cm or not instr.operands:
        return 2.0 * out_elems
    lhs = symbols.get(instr.operands[0])
    if lhs is None:
        return 2.0 * out_elems
    dims = shape_dims(lhs.out_shape)
    k = 1
    for d in (int(x) for x in cm.group(1).split(",") if x != ""):
        if d < len(dims):
            k *= dims[d]
    return 2.0 * out_elems * k


def _fusion_read_bytes(instr: Instruction, sym: dict, parsed: dict) -> float:
    """HBM reads of a fusion: operands, except that a parameter whose only
    use inside the fused computation is the *gathered* operand of a
    gather/dynamic-slice contributes only the gathered rows (otherwise a
    paged-KV pool would be counted in full on every page step)."""
    comp = parsed.get(instr.called[0]) if instr.called else None
    total = 0.0
    if comp is None:
        for o in instr.operands:
            if o in sym:
                total += shape_bytes(sym[o].out_shape)
        return total
    # map parameter index -> gather-only? and gathered-output bytes
    params: dict[int, Instruction] = {}
    for fi in comp:
        if fi.opcode == "parameter":
            mnum = re.search(r"parameter\((\d+)\)", fi.raw)
            if mnum:
                params[int(mnum.group(1))] = fi
    for idx, o in enumerate(instr.operands):
        if o not in sym:
            continue
        full = shape_bytes(sym[o].out_shape)
        p_instr = params.get(idx)
        if p_instr is not None:
            users = [fi for fi in comp if p_instr.name in fi.operands]
            if users and all(u.opcode in ("gather", "dynamic-slice")
                             and u.operands and u.operands[0] == p_instr.name
                             for u in users):
                total += sum(shape_bytes(u.out_shape) for u in users)
                continue
        total += full
    return total


def analyze_hlo(hlo: str) -> HLOAnalysis:
    comps, entry = _parse_computations(hlo)
    symtabs = {name: {i.name: i for i in instrs}
               for name, instrs in comps.items()}

    mult: dict[str, float] = defaultdict(float)

    def walk(comp: str, m: float, depth=0):
        if depth > 100 or comp not in comps:
            return
        mult[comp] += m
        for instr in comps[comp]:
            child_m = m * (instr.trip_count if instr.opcode == "while" else 1)
            for c in instr.called:
                walk(c, child_m, depth + 1)

    walk(entry, 1.0)

    res = HLOAnalysis()
    res.computations = len(comps)
    breakdown: dict[str, float] = defaultdict(float)
    for comp, instrs in comps.items():
        m = mult.get(comp, 0.0)
        if m == 0.0:
            continue
        sym = symtabs[comp]
        for instr in instrs:
            op = instr.opcode
            if op in ("dot", "dot-general"):
                res.dot_flops += m * _dot_flops(instr, sym)
                res.dot_count += 1
            elif any(op.startswith(c) for c in _COLLECTIVES):
                b = sum(shape_bytes(sym[o].out_shape) for o in instr.operands
                        if o in sym) or shape_bytes(instr.out_shape)
                res.collective_bytes += m * b
                base = op
                for suf in ("-start", "-done"):
                    base = base[:-len(suf)] if base.endswith(suf) else base
                breakdown[base] += m * b
                res.collective_count += 1
            if op in ("fusion", "dot", "dot-general", "custom-call",
                      "convolution", "copy", "gather", "dynamic-slice") \
                    or any(op.startswith(c) for c in _COLLECTIVES):
                io = shape_bytes(instr.out_shape)
                operand_bytes = [shape_bytes(sym[o].out_shape)
                                 for o in instr.operands if o in sym]
                if op in ("gather", "dynamic-slice"):
                    # reads only the gathered rows, not the whole operand
                    io += shape_bytes(instr.out_shape)
                elif op == "fusion" and instr.called:
                    io += _fusion_read_bytes(instr, sym, parsed=comps)
                else:
                    io += sum(operand_bytes)
                res.hbm_bytes += m * io
    res.collective_breakdown = dict(breakdown)
    return res
