"""vawk-equivalent in-process VCF record filtering.

The reference pipes per-window VCF through vawk (VCF-aware awk,
.gitmodules:7-9) with expressions like
``'$6>=QUAL && I$RPR>0 && I$RPL>0'`` (bin/speedseq:709) and uses it for
SV annotation routing (:1595,1615).  This module evaluates the same
expression surface in-process:

- ``$1``..``$9``  positional VCF columns ($2 POS, $6 QUAL, ...)
- ``I$TAG``       INFO field value (numeric when possible; flags → 1)
- ``S$n$TAG``     sample n's FORMAT field (0-based)
- comparison / arithmetic / boolean operators with awk semantics
  (missing values compare as 0/empty string)

Expressions are compiled once into Python callables over VCFRecord.
"""

from __future__ import annotations

import re
from typing import Callable, Optional

from .vcf import VCFRecord

_TOKEN = re.compile(
    r"""(I\$[A-Za-z_][A-Za-z0-9_]*      # INFO ref
       |S\$\d+\$[A-Za-z_][A-Za-z0-9_]*  # sample ref
       |\$\d+                           # column ref
       |&&|\|\||==|!=|>=|<=|[<>]
       |[-+*/%()!]
       |"[^"]*"
       |[0-9.eE+-]+
       )""",
    re.X,
)


def _num(v) -> float:
    """awk-style numeric coercion: non-numeric → 0.

    A-typed INFO values arrive as Python lists for multi-allelic sites;
    vawk sees the serialized "3,1" string and awk-coerces it to the
    leading number, so lists coerce via their first element here too.
    """
    if v is None or v is True:
        return 1.0 if v is True else 0.0
    if isinstance(v, (list, tuple)):
        return _num(v[0]) if v else 0.0
    if isinstance(v, (int, float)):
        return float(v)
    try:
        return float(str(v).split(",")[0])
    except (ValueError, TypeError):
        return 0.0


def _col(rec: VCFRecord, i: int):
    if i == 1:
        return rec.chrom
    if i == 2:
        return rec.pos + 1
    if i == 3:
        return rec.id
    if i == 4:
        return rec.ref
    if i == 5:
        return ",".join(rec.alt)
    if i == 6:
        return rec.qual if rec.qual is not None else 0
    if i == 7:
        return rec.filter
    if i == 8:
        return rec.info_str()
    if i == 9:
        return ":".join(rec.format)
    return ""


def compile_filter(expr: str) -> Callable[[VCFRecord], bool]:
    """Compile a vawk-style expression to a predicate over VCFRecord."""
    py = []
    pos = 0
    for m in _TOKEN.finditer(expr):
        if m.start() > pos and expr[pos : m.start()].strip():
            raise ValueError(f"bad filter syntax near: {expr[pos:m.start()]!r}")
        t = m.group(0)
        if t.startswith("I$"):
            py.append(f"_num(rec.info.get({t[2:]!r}))")
        elif t.startswith("S$"):
            _, n, tag = t.split("$")
            py.append(
                f"_num(rec.samples[{int(n)}].get({tag!r}) "
                f"if len(rec.samples) > {int(n)} else 0)"
            )
        elif t.startswith("$"):
            py.append(f"_num(_col(rec, {int(t[1:])}))")
        elif t == "&&":
            py.append(" and ")
        elif t == "||":
            py.append(" or ")
        elif t == "!":
            py.append(" not ")
        elif t.startswith('"'):
            py.append(t)
        else:
            py.append(t)
        pos = m.end()
    if expr[pos:].strip():
        raise ValueError(f"bad filter syntax near: {expr[pos:]!r}")
    code = compile("".join(py), "<vcf_filter>", "eval")

    def predicate(rec: VCFRecord) -> bool:
        return bool(eval(code, {"_num": _num, "_col": _col, "rec": rec}))

    return predicate


def filter_records(records, expr: str):
    pred = compile_filter(expr)
    return [r for r in records if pred(r)]
