"""Collective traffic: the port of ``repro/launch/hlo.py``.

``DTYPE_BYTES``, ``COLLECTIVES``, ``shape_bytes`` and
``parse_hlo_collectives`` are the reference's HLO-text parsers, copied:
they read the optimized HLO an XLA compile prints.  The port compiles no
HLO; its collectives are the emulated mesh's own calls, which
``parallel/mesh.py`` logs inside its ``collective_log()`` context.
``collective_report`` fills the parser's layout from that log.
"""
from __future__ import annotations

import re

DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "f8e4m3fn": 1, "f8e5m2": 1,
    "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
    "s32": 4, "u32": 4, "f32": 4,
    "s64": 8, "u64": 8, "f64": 8, "c64": 8,
    "c128": 16,
}

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

_SHAPE_RE = re.compile(r"\b([a-z0-9]+)\[([0-9,]*)\]")
_DEF_RE = re.compile(r"^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=\s*(.*)$")
_OPND_RE = re.compile(r"%([\w.\-]+)")


def shape_bytes(type_str: str) -> int:
    """Sum byte sizes of every dtype[shape] group in a type string
    (handles tuples)."""
    total = 0
    for dt, dims in _SHAPE_RE.findall(type_str):
        if dt not in DTYPE_BYTES:
            continue
        n = 1
        if dims:
            for d in dims.split(","):
                n *= int(d)
        total += n * DTYPE_BYTES[dt]
    return total


def _empty_report() -> dict:
    return {k: {"count": 0, "operand_bytes": 0, "result_bytes": 0}
            for k in COLLECTIVES}


def _with_total(out: dict) -> dict:
    out["total"] = {f: sum(v[f] for v in out.values())
                    for f in ("count", "operand_bytes", "result_bytes")}
    return out


def parse_hlo_collectives(hlo_text: str) -> dict:
    """Returns {op_kind: {"count": n, "operand_bytes": b, "result_bytes": b}}
    plus a "total" entry."""
    sizes: dict[str, int] = {}
    lines = hlo_text.splitlines()
    # pass 1: symbol table of result sizes
    for ln in lines:
        m = _DEF_RE.match(ln)
        if not m:
            continue
        name, rhs = m.groups()
        paren = rhs.find(" ")
        head = rhs.split(" ", 1)[0] if paren > 0 else rhs
        sizes[name] = shape_bytes(head)
    # pass 2: collectives
    out = _empty_report()
    for ln in lines:
        m = _DEF_RE.match(ln)
        if not m:
            continue
        name, rhs = m.groups()
        kind = None
        for k in COLLECTIVES:
            if re.search(rf"\)?\s{k}(-start)?\(", rhs) or \
               rhs.split("(")[0].strip().endswith(k) or \
               f" {k}(" in rhs or f" {k}-start(" in rhs:
                kind = k
                break
        if kind is None:
            continue
        # ignore the matching -done ops (they'd double count)
        if f"{kind}-done" in rhs:
            continue
        ent = out[kind]
        ent["count"] += 1
        head = rhs.split(" ", 1)[0]
        ent["result_bytes"] += shape_bytes(head)
        args = rhs[rhs.find("("):]
        # operands named inside the parens; strip attributes after ')'
        depth, end = 0, len(args)
        for i, ch in enumerate(args):
            if ch == "(":
                depth += 1
            elif ch == ")":
                depth -= 1
                if depth == 0:
                    end = i
                    break
        opnds = _OPND_RE.findall(args[:end])
        ent["operand_bytes"] += sum(sizes.get(o, 0) for o in opnds)
    return _with_total(out)


def collective_report(log) -> dict:
    """The ``parse_hlo_collectives`` layout from a mesh's collective log
    (``(kind, operand bytes, result bytes)`` a call, a rank's bytes)."""
    out = _empty_report()
    for kind, opnd, res in log:
        ent = out[kind]
        ent["count"] += 1
        ent["operand_bytes"] += opnd
        ent["result_bytes"] += res
    return _with_total(out)
