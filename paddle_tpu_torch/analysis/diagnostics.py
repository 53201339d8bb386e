"""Structured diagnostics of the program analyses (counterpart of
``paddle_tpu/analysis/diagnostics.py``).

Every finding is a :class:`Diagnostic` with a stable code, a severity, the
op's position and the user call site recorded in the op's ``op_callstack``
attr. The catalogue holds the codes of the passes ported so far: liveness
(PT500-PT504) and GEMM-epilogue fusion (PT750-PT756), with the JAX
package's meanings; the verifier's codes arrive with the verifier.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

__all__ = ["Diagnostic", "Severity", "CODES", "ProgramVerificationError",
           "format_diagnostics"]


class Severity:
    ERROR = "error"      # the program cannot run / computes garbage
    WARNING = "warning"  # suspicious; runs, but likely not what was meant
    INFO = "info"        # observation; never gates


# code -> (severity, one-line meaning)
CODES = {
    # -- liveness & effects ----------------------------------------------
    "PT500": (Severity.WARNING,
              "donation-unsafe fetch: var is updated in place AND fetched; "
              "its buffer is excluded from donation"),
    "PT501": (Severity.WARNING,
              "write-after-fetch: var is rewritten after an explicit fetch "
              "op (compiled steps fetch final values)"),
    "PT502": (Severity.INFO,
              "dead op: no output is read, fetched or persistable"),
    "PT503": (Severity.INFO,
              "dead var: declared but never read or written by any op"),
    "PT504": (Severity.ERROR,
              "persistable var written inside a sub-block never escapes to "
              "the scope (state threading only scans the global block)"),
    # -- epilogue_fusion transform (analysis/epilogue_fusion.py) ---------
    "PT750": (Severity.INFO,
              "GEMM-epilogue chain fused into one fused_gemm_epilogue op"),
    "PT751": (Severity.INFO,
              "fusion refused: a chain intermediate is fetched — the "
              "caller observes the unfused value"),
    "PT752": (Severity.INFO,
              "fusion refused: a chain intermediate has more than one "
              "consumer — fusing would recompute or break a reader"),
    "PT753": (Severity.INFO,
              "fusion refused: program carries backward/optimizer ops "
              "(epilogue fusion only proves forward-only rewrites)"),
    "PT754": (Severity.WARNING,
              "fusion fidelity witness failed — the program runs "
              "untransformed (never a wrong program)"),
    "PT755": (Severity.INFO,
              "fused chain has no kernel tiling on this device — the "
              "dense replay of the original op rules will run"),
    "PT756": (Severity.INFO,
              "fusion refused: an op between the chain's ops rewrites a "
              "var the chain reads — the fused op's relocated reads "
              "would see the redefined value"),
}


@dataclasses.dataclass
class Diagnostic:
    code: str
    message: str
    block_idx: int = 0
    op_idx: Optional[int] = None
    op_type: Optional[str] = None
    site: str = ""  # user call site from the op's op_callstack attr

    @property
    def severity(self) -> str:
        return CODES[self.code][0]

    def __str__(self) -> str:
        loc = f"block {self.block_idx}"
        if self.op_idx is not None:
            loc += f" op {self.op_idx}"
        if self.op_type:
            loc += f" ({self.op_type})"
        s = f"{self.code} {self.severity}: {self.message} [{loc}]"
        if self.site:
            s += f"\n    created at {self.site}"
        return s


def format_diagnostics(diags: List[Diagnostic]) -> str:
    if not diags:
        return "no findings"
    order = {Severity.ERROR: 0, Severity.WARNING: 1, Severity.INFO: 2}
    by_sev = sorted(diags, key=lambda d: (order[d.severity], d.block_idx,
                                          d.op_idx if d.op_idx is not None
                                          else -1))
    counts = {}
    for d in diags:
        counts[d.severity] = counts.get(d.severity, 0) + 1
    head = ", ".join(f"{counts[s]} {s}(s)" for s in
                     (Severity.ERROR, Severity.WARNING, Severity.INFO)
                     if s in counts)
    return head + "\n" + "\n".join(str(d) for d in by_sev)


class ProgramVerificationError(ValueError):
    """Raised when error-severity findings exist; carries the full
    diagnostic list so callers can inspect it."""

    def __init__(self, diags: List[Diagnostic]):
        self.diagnostics = diags
        errors = [d for d in diags if d.severity == Severity.ERROR]
        super().__init__(
            f"program verification failed with {len(errors)} error(s):\n"
            + format_diagnostics(diags))
