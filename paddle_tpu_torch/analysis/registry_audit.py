"""Op-registry conformance/coverage audit over the port's registry
(counterpart of ``paddle_tpu/analysis/registry_audit.py``): dumps, per
registered op, which capabilities it implements — explicit infer_shape,
op rule, grad story, rng/raw flags — and whether any of the port's test
files (``test_torch_*.py``) mentions it.
"""
from __future__ import annotations

import os
import re
from typing import Dict, List, Optional

from ..core import registry

__all__ = ["audit_registry", "format_audit", "coverage_summary"]


def _grad_mode(opdef) -> str:
    if opdef.grad_lower is not None:
        return "custom-lower"
    if opdef.grad is None:
        return "none"
    if callable(opdef.grad):
        return "custom-maker"
    return "auto-vjp"


def _tested_ops(test_dir: str) -> Dict[str, bool]:
    """One scan of the port's test files (``test_torch_*.py``); an op
    counts as tested if its name appears as a word anywhere (direct
    append_op use or through its layer wrapper of the same name)."""
    blob = []
    for fn in sorted(os.listdir(test_dir)):
        if fn.startswith("test_torch_") and fn.endswith(".py"):
            with open(os.path.join(test_dir, fn), "r",
                      encoding="utf-8", errors="replace") as f:
                blob.append(f.read())
    text = "\n".join(blob)
    words = set(re.findall(r"[A-Za-z_][A-Za-z_0-9]*", text))
    return {op: (op in words) for op in registry.all_ops()}


def audit_registry(test_dir: Optional[str] = None) -> List[dict]:
    """One row per registered op, sorted by name."""
    tested = _tested_ops(test_dir) if test_dir else None
    rows = []
    for name in registry.all_ops():
        opdef = registry.get_op_def(name)
        rows.append({
            "op": name,
            "infer_shape": ("explicit" if opdef.infer_shape is not None
                            else "auto" if opdef.lower is not None
                            else "none"),
            "lower": opdef.lower is not None,
            "grad": _grad_mode(opdef),
            "needs_rng": opdef.needs_rng,
            "raw": opdef.raw,
            "tested": None if tested is None else tested[name],
        })
    return rows


def coverage_summary(rows: List[dict]) -> dict:
    n = len(rows)
    return {
        "ops": n,
        "with_lower": sum(r["lower"] for r in rows),
        "explicit_infer_shape": sum(r["infer_shape"] == "explicit"
                                    for r in rows),
        "differentiable": sum(r["grad"] != "none" for r in rows),
        "tested": (sum(bool(r["tested"]) for r in rows)
                   if rows and rows[0]["tested"] is not None else None),
    }


def format_audit(rows: List[dict]) -> str:
    cols = ["op", "infer_shape", "lower", "grad", "needs_rng", "raw",
            "tested"]
    if rows and rows[0]["tested"] is None:
        cols = cols[:-1]

    def cell(v):
        if v is True:
            return "yes"
        if v is False:
            return "-"
        return str(v)

    widths = {c: max(len(c), max((len(cell(r[c])) for r in rows),
                                 default=0)) for c in cols}
    lines = ["  ".join(c.ljust(widths[c]) for c in cols),
             "  ".join("-" * widths[c] for c in cols)]
    for r in rows:
        lines.append("  ".join(cell(r[c]).ljust(widths[c]) for c in cols))
    s = coverage_summary(rows)
    lines.append("")
    tail = (f"{s['ops']} ops | lower: {s['with_lower']} | explicit "
            f"infer_shape: {s['explicit_infer_shape']} | differentiable: "
            f"{s['differentiable']}")
    if s["tested"] is not None:
        tail += f" | referenced by tests: {s['tested']}"
    lines.append(tail)
    return "\n".join(lines)
