"""Structured diagnostics of the program analyses (counterpart of
``paddle_tpu/analysis/diagnostics.py``).

Every finding is a :class:`Diagnostic` with a stable code, a severity, the
op's position and the user call site recorded in the op's ``op_callstack``
attr. The catalogue holds the codes of the passes ported so far, with the
JAX package's meanings: the verifier (PT100-PT401), liveness
(PT500-PT504), the static checks (PT700-PT722), GEMM-epilogue fusion
(PT750-PT756), the source-level concurrency lint (PT800-PT802) and
numerics (PT900-PT906). The sharding analysis' PT730-PT744 arrive with
the slice that ports it.
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
    # -- pass 1: schema conformance ------------------------------------
    "PT100": (Severity.ERROR,
              "op type is not in the registry (and is not an auto-grad op)"),
    "PT101": (Severity.ERROR, "required input slot absent or empty"),
    "PT102": (Severity.ERROR, "input slot not declared by the op's schema"),
    "PT103": (Severity.ERROR, "required output slot absent or empty"),
    "PT104": (Severity.ERROR, "output slot not declared by the op's schema"),
    "PT105": (Severity.ERROR, "required attr missing"),
    "PT106": (Severity.WARNING, "attr not declared by the op's schema"),
    "PT107": (Severity.ERROR, "non-duplicable slot holds more than one var"),
    # -- pass 2: dataflow ----------------------------------------------
    "PT200": (Severity.ERROR,
              "var is read before the op that produces it (use-before-def)"),
    "PT201": (Severity.WARNING,
              "var is read but never produced, fed or scope-initialized"),
    "PT202": (Severity.WARNING,
              "write-after-write: earlier value is dead (never read)"),
    "PT203": (Severity.INFO,
              "op output is never read, not fetched and not persistable"),
    # -- pass 3: lowerability ------------------------------------------
    "PT300": (Severity.ERROR, "op's OpDef has no lower rule"),
    "PT301": (Severity.WARNING,
              "grad op whose forward op declares grad=None"),
    "PT302": (Severity.WARNING,
              "needs_rng op under FLAGS_cudnn_deterministic"),
    # -- pass 4: shape/dtype replay ------------------------------------
    "PT400": (Severity.WARNING,
              "replayed infer_shape disagrees with recorded var shape"),
    "PT401": (Severity.WARNING,
              "replayed infer_shape disagrees with recorded var dtype"),
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
    # -- pass: dtype/shape consistency (whole-program replay) ----------
    "PT700": (Severity.ERROR,
              "op's infer_shape fails under whole-program replay — the "
              "producer/consumer metadata contract is broken"),
    "PT701": (Severity.WARNING,
              "producer/consumer shape mismatch: whole-program replay "
              "propagates a shape a later consumer's record disagrees "
              "with"),
    "PT702": (Severity.WARNING,
              "producer/consumer dtype mismatch: whole-program replay "
              "propagates a dtype a later consumer's record disagrees "
              "with"),
    "PT703": (Severity.WARNING,
              "conflicting producers: two ops write the same var with "
              "different inferred shape/dtype"),
    "PT704": (Severity.INFO,
              "consumer reads a var with no recorded shape — propagation "
              "is blind past this boundary"),
    # -- pass: donation/alias race detector ----------------------------
    "PT710": (Severity.INFO,
              "donation race avoided: the state_in∩state_out heuristic "
              "would donate the var but a later op still reads it after "
              "its last write — the liveness proof refuses it (safe, but "
              "costs a host copy per step)"),
    "PT711": (Severity.WARNING,
              "unordered double write: two ops write the var with no "
              "data dependency or intervening read ordering them"),
    "PT712": (Severity.WARNING,
              "donated buffer aliased into a fetch: a fetched var is a "
              "view of a donated var taken before its in-place update"),
    "PT713": (Severity.WARNING,
              "op writes a feed var in place — the fed host buffer and "
              "the scope copy can diverge"),
    # -- pass: dead/unreachable code lint -------------------------------
    "PT720": (Severity.WARNING,
              "transitively dead op: every output flows only into other "
              "dead ops (never reaches a fetch, persistable or effect)"),
    "PT721": (Severity.INFO,
              "unused output: one output of an otherwise-live op is "
              "never read, fetched or persistable"),
    "PT722": (Severity.WARNING,
              "unreachable sub-block: no op references the block via its "
              "sub_block attr"),
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
    # -- source-level concurrency analysis (analysis/concurrency.py) ----
    # These three codes lint the port's own Python source (lock
    # attributes, with-regions, thread entry points), not a Program IR;
    # Diagnostic.site carries file:line instead of an op_callstack.
    "PT800": (Severity.ERROR,
              "lock-order cycle: the static lock-order graph (nested "
              "with-regions + calls made while holding a lock) contains "
              "a cycle — two threads taking the locks in opposing order "
              "deadlock"),
    "PT801": (Severity.WARNING,
              "blocking call under a held lock: time.sleep, socket/HTTP "
              "I/O, subprocess waits, Event.wait() without timeout, "
              "torch.cuda.synchronize or a CUDA stream/event synchronize, "
              "or an unbounded queue op runs while a lock is held — every "
              "other thread needing the lock stalls for the full blocking "
              "duration"),
    "PT802": (Severity.WARNING,
              "unguarded cross-thread attribute: reachable from more "
              "than one thread entry point with at least one write and "
              "at least one access outside any lock region"),
    # -- numerics / precision analysis (analysis/numerics.py) -----------
    "PT900": (Severity.ERROR,
              "broken quant/dequant pairing: a fake-quant output is "
              "consumed where the int8 rewrite contract does not hold "
              "(non-GEMM consumer), or the quantized value is never "
              "consumed at all"),
    "PT901": (Severity.WARNING,
              "dead or non-persistable moving-average scale state in a "
              "training program: the running activation scale is not "
              "persistable (reset every step) or its update is never "
              "written back in place (the moving average never "
              "advances)"),
    "PT902": (Severity.ERROR,
              "overflowing cast: the statically-proven value interval "
              "exceeds the target dtype's finite range"),
    "PT903": (Severity.WARNING,
              "reduction accumulated in low precision: a reduce/"
              "layer_norm-family op sums a float16/bfloat16 input into a "
              "float16/bfloat16 output with no upcast around the "
              "accumulation"),
    "PT904": (Severity.WARNING,
              "AMP loss-scale coverage gap: loss scaling is active "
              "(check_finite_and_unscale present) but a gradient reaches "
              "an optimizer update without passing through unscale"),
    "PT905": (Severity.WARNING,
              "nonfinite-producing op: log/sqrt/rsqrt/div on an interval "
              "statically proven to contain 0 or negatives, with no "
              "guard narrowing the operand first"),
    "PT906": (Severity.INFO,
              "quantizable GEMM/conv site: eligible for int8 epilogue "
              "lowering (the quantizability work-list an int8 "
              "lowering consumes)"),
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
    """Raised by ``check_program`` when error-severity findings exist;
    carries the full diagnostic list so callers can inspect it."""

    def __init__(self, diags: List[Diagnostic]):
        self.diagnostics = diags
        errors = [d for d in diags if d.severity == Severity.ERROR]
        super().__init__(
            f"program verification failed with {len(errors)} error(s) "
            f"(FLAGS_check_program):\n"
            + format_diagnostics(diags))
