"""Numerics static analysis — value-interval and precision-flow
propagation over the Program IR (the PT900 family; counterpart of
``paddle_tpu/analysis/numerics.py``, with its whole transfer table, rules
for op types the port does not register yet included).

Which GEMM/conv sites are *provably* safe to lower to int8, are the QAT
annotations well-formed, and where does the bf16/AMP path silently lose
precision? This pass answers it statically, the way ``dtype_shape_check``
answers the shape question: walk every op in program order over the
recorded ``infer_shape`` metadata, propagating a conservative **value
interval** ``[lo, hi]`` per var (abs-max / min-max; ``TOP`` = (-inf, inf)
wherever no transfer rule applies — soundness over precision) plus the
dtype-precision flow the var metadata already records.

Transfer rules by op family:

* **contraction growth** — conv2d/depthwise_conv2d/mul/matmul: |out| <=
  |x|max * |y|max * K where K is the contraction width read off the
  recorded shapes (unknown/dynamic K => TOP);
* **domain hazards** — log/sqrt/rsqrt/reciprocal/elementwise_div on an
  interval statically proven to include 0 or negatives emit PT905 (a
  guard — clip, +eps, abs — narrows the interval and clears the finding
  by construction);
* **accumulation** — reduce_*/sum/mean/layer_norm scale bounds by the
  reduction width and emit PT903 when a float16/bfloat16 input
  accumulates into a float16/bfloat16 output with no upcast;
* **range-bounded activations** — relu/sigmoid/tanh/softmax/clip/... give
  the tight bounds the runtime witness (monitor/numwitness.py) cross-checks
  observed values against, tolerance-free: every bound here must be TRUE,
  never heuristic;
* **fake-quant/dequant** — the QAT rewrite contract: PT900 when a
  fake-quant output is consumed off the GEMM path (or never), PT901 when
  moving-average scale state cannot survive training steps.

Whole-program checks on top of the walk: PT902 (cast whose proven interval
exceeds the target dtype's finite range), PT904 (AMP loss-scale coverage:
a grad reaching an optimizer update without passing through
``check_finite_and_unscale`` while scaling is active) and the info-level
PT906 quantizability report — one finding per forward GEMM/conv site,
carrying contraction width, quant-annotation state and static/calibrated
abs-max. PT906 is the exact work-list an int8 epilogue lowering
consumes, and is a superset of ``epilogue_fusion``'s fusable chain
bases.

Calibration: ``ctx.options["numerics_calibration"] = {var: absmax}`` (the
witness's observed abs-max) seeds feed/param intervals. Calibrated intervals are *observed*, not
proven — they are tracked separately (``NumericsReport.calibrated``) and
excluded from the witness containment contract.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Set, Tuple

from ..framework import OpRole
from .diagnostics import Diagnostic
from .verifier import EMPTY, _site

__all__ = [
    "Interval", "TOP", "NumericsReport", "check_numerics",
    "analyze_numerics", "static_intervals", "DTYPE_FINITE_MAX",
    "LOW_PRECISION_DTYPES", "QUANT_SITE_TYPES", "FAKE_QUANT_TYPES",
    "QUANT_CONSUMER_TYPES",
]

_INF = math.inf

# finite-range table for PT902 (overflowing cast); names follow the IR's
# string dtypes
DTYPE_FINITE_MAX = {
    "float16": 65504.0,
    "bfloat16": 3.3895313892515355e38,
    "float32": 3.4028234663852886e38,
    "float64": 1.7976931348623157e308,
    "int8": 127.0,
    "uint8": 255.0,
    "int16": 32767.0,
    "int32": 2147483647.0,
    "int64": 9.223372036854775e18,
}

LOW_PRECISION_DTYPES = frozenset({"float16", "bfloat16"})

# the GEMM/conv families a QAT pass annotates and an int8 lowering takes —
# for mul/matmul, epilogue_fusion._BASE_TYPES
QUANT_SITE_TYPES = ("conv2d", "depthwise_conv2d", "mul", "matmul")

# legal consumers of a fake-quant output under the int8 rewrite contract:
# the GEMM/conv site itself, the fused form of that site, or the site's
# grad replay (training programs read the quantized activation from the
# backward ops)
QUANT_CONSUMER_TYPES = frozenset(QUANT_SITE_TYPES) | {"fused_gemm_epilogue"}

FAKE_QUANT_TYPES = frozenset({
    "fake_quantize_dequantize_abs_max",
    "fake_quantize_dequantize_moving_average_abs_max",
})

# reduce-family ops whose accumulation order/precision PT903 polices
_REDUCE_TYPES = frozenset({
    "reduce_sum", "reduce_mean", "sum", "mean", "layer_norm",
    "softmax", "softmax_with_cross_entropy", "squared_l2_norm",
})


@dataclasses.dataclass(frozen=True)
class Interval:
    """Conservative value bound: every element of the var lies in
    ``[lo, hi]`` (TRUE bound, never heuristic — the runtime witness
    asserts tolerance-free containment against it)."""

    lo: float = -_INF
    hi: float = _INF

    @property
    def is_top(self) -> bool:
        return self.lo == -_INF and self.hi == _INF

    @property
    def known(self) -> bool:
        """At least one side carries derived information."""
        return not self.is_top

    @property
    def absmax(self) -> float:
        return max(abs(self.lo), abs(self.hi))

    def contains_zero(self) -> bool:
        return self.lo <= 0.0 <= self.hi

    def hull(self, other: "Interval") -> "Interval":
        return Interval(min(self.lo, other.lo), max(self.hi, other.hi))

    def scaled(self, f: float) -> "Interval":
        a, b = _mul_bound(self.lo, f), _mul_bound(self.hi, f)
        return Interval(min(a, b), max(a, b))

    def shifted(self, b: float) -> "Interval":
        return Interval(self.lo + b, self.hi + b)

    def to_tuple(self) -> Tuple[float, float]:
        return (self.lo, self.hi)


TOP = Interval()
_UNIT = Interval(0.0, 1.0)          # sigmoid / softmax / dropout-mask
_SYM_UNIT = Interval(-1.0, 1.0)     # tanh / softsign / erf / sin / cos
_NON_NEG = Interval(0.0, _INF)      # losses, variances, abs-max scales


def _sym(m: float) -> Interval:
    return Interval(-abs(m), abs(m))


def _pt(v: float) -> Interval:
    return Interval(float(v), float(v))


def _mul_bound(a: float, b: float) -> float:
    """IEEE-safe product for bound arithmetic: 0 * inf is 0 here (an
    exactly-zero value stays zero no matter the other operand's bound)."""
    if a == 0.0 or b == 0.0:
        return 0.0
    return a * b


# Rounding slack for transfer rules that model runtime FLOAT ARITHMETIC
# (scale, elementwise_*, exp, GEMM, reductions, ...): bounds here are
# computed in float64 while the runtime computes AND STORES float32 — a
# fill_constant(1e-4) materializes as the float32 9.9999997e-05, outside
# the exact python-float interval. Widening each derived bound by 8
# float32 ulps per arithmetic op strictly dominates the <= 0.5 ulp the
# runtime can add per op, so containment holds inductively down any
# chain — and the WITNESS cross-check stays tolerance-free, because the
# slack is part of the proven bound, not of the comparison. Structural
# rules (relu/clip/min/max/concat/fixed activation ranges) stay exact:
# they model no rounding. Accumulations (GEMM/reduce_sum) additionally
# scale slack by the contraction width K — fp32 accumulation error grows
# ~K * 2^-24, which a fixed factor cannot cover.
_REL_SLACK = 2.0 ** -20
_ABS_SLACK = 2.0 ** -126      # smallest fp32 normal: subnormal rounding

# extra relative widening when a cast stores into a narrower float
_CAST_REL = {"float16": 2.0 ** -10, "bfloat16": 2.0 ** -7,
             "float32": 2.0 ** -23}


def _slop(iv: Interval, width: float = 1.0) -> Interval:
    rel = _REL_SLACK + float(width) * 2.0 ** -23
    lo = iv.lo if iv.lo == -_INF else iv.lo - abs(iv.lo) * rel - _ABS_SLACK
    hi = iv.hi if iv.hi == _INF else iv.hi + abs(iv.hi) * rel + _ABS_SLACK
    return Interval(lo, hi)


def _iv_add(a: Interval, b: Interval) -> Interval:
    return Interval(a.lo + b.lo, a.hi + b.hi)


def _iv_sub(a: Interval, b: Interval) -> Interval:
    return Interval(a.lo - b.hi, a.hi - b.lo)


def _iv_mul(a: Interval, b: Interval) -> Interval:
    ps = [_mul_bound(x, y) for x in (a.lo, a.hi) for y in (b.lo, b.hi)]
    return Interval(min(ps), max(ps))


def _safe_exp(v: float) -> float:
    if v == -_INF:
        return 0.0
    try:
        return math.exp(v)
    except OverflowError:
        return _INF


def _abs_iv(a: Interval) -> Interval:
    if a.contains_zero():
        return Interval(0.0, a.absmax)
    return Interval(min(abs(a.lo), abs(a.hi)), a.absmax)


@dataclasses.dataclass
class NumericsReport:
    """Everything the walk derived: the analysis product cached under
    ``ctx.analysis("numerics_check")`` and serialized into the CI
    artifact."""

    diagnostics: List[Diagnostic] = dataclasses.field(default_factory=list)
    intervals: Dict[str, Interval] = dataclasses.field(default_factory=dict)
    quant_sites: List[dict] = dataclasses.field(default_factory=list)
    calibrated: Set[str] = dataclasses.field(default_factory=set)
    is_training: bool = False
    loss_scaling_active: bool = False

    def bounded_intervals(self, proven_only: bool = True
                          ) -> Dict[str, Tuple[float, float]]:
        """Vars with at least one finite bound — the witness containment
        surface. ``proven_only`` drops everything downstream of a
        calibration seed (observed, not proven)."""
        out = {}
        for name, iv in self.intervals.items():
            if not iv.known:
                continue
            if proven_only and name in self.calibrated:
                continue
            out[name] = iv.to_tuple()
        return out

    def to_dict(self) -> dict:
        by_code: Dict[str, int] = {}
        for d in self.diagnostics:
            by_code[d.code] = by_code.get(d.code, 0) + 1
        return {
            "is_training": self.is_training,
            "loss_scaling_active": self.loss_scaling_active,
            "findings_by_code": by_code,
            "bounded_intervals": {
                n: [lo, hi] for n, (lo, hi)
                in sorted(self.bounded_intervals(proven_only=False).items())},
            "calibrated_vars": sorted(self.calibrated),
            "quant_sites": list(self.quant_sites),
        }


def _find_var(block, name: str):
    b = block
    while b is not None:
        v = b.vars.get(name)
        if v is not None:
            return v
        b = b.parent_block
    return None


def _var_dtype(block, name: str) -> str:
    v = _find_var(block, name)
    return str(getattr(v, "dtype", "") or "") if v is not None else ""


def _var_shape(block, name: str):
    v = _find_var(block, name)
    return getattr(v, "shape", None) if v is not None else None


def _static_width(shape, axes=None) -> Optional[int]:
    """Product of the (reduced) dims, None when any is dynamic."""
    if shape is None:
        return None
    dims = list(shape)
    if axes is not None:
        try:
            dims = [dims[a if a >= 0 else a + len(dims)] for a in axes]
        except (IndexError, TypeError):
            return None
    w = 1
    for d in dims:
        d = int(d)
        if d < 0:
            return None
        w *= d
    return w


def _role(op):
    return op.attrs.get("__op_role__", OpRole.Forward)


def _diag(diags, code, msg, block, op_idx, op):
    diags.append(Diagnostic(code, msg, block_idx=block.idx, op_idx=op_idx,
                            op_type=op.type, site=_site(op)))


# ---------------------------------------------------------------------------
# per-op transfer rules
# ---------------------------------------------------------------------------

def _contraction_width(block, op) -> Optional[int]:
    """K of a GEMM/conv site from the recorded shapes (None = dynamic)."""
    t = op.type
    if t in ("conv2d", "depthwise_conv2d"):
        f = op.input("Filter")
        shape = _var_shape(block, f[0]) if f else None
        if shape is None or len(shape) != 4:
            return None
        return _static_width(shape[1:])              # ic * kh * kw
    if t == "mul":
        y = op.input("Y")
        shape = _var_shape(block, y[0]) if y else None
        if shape is None or len(shape) < 2:
            return None
        ncd = int(op.attrs.get("y_num_col_dims", 1))
        return _static_width(shape[:ncd])
    if t == "matmul":
        xn = op.input("X")
        shape = _var_shape(block, xn[0]) if xn else None
        if shape is None or len(shape) < 1:
            return None
        axis = -2 if op.attrs.get("transpose_X", False) else -1
        try:
            k = int(shape[axis])
        except (IndexError, TypeError):
            return None
        return k if k >= 0 else None
    return None


def _transfer(block, op, env: Dict[str, Interval],
              diags: List[Diagnostic], op_idx: int) -> Dict[str, Interval]:
    """Output intervals of one op; hazard diagnostics (PT902/PT903/PT905)
    are emitted as a side effect. Anything not covered maps to TOP."""

    def iv(slot: str, idx: int = 0) -> Interval:
        names = op.input(slot)
        if len(names) <= idx or names[idx] == EMPTY:
            return TOP
        return env.get(names[idx], TOP)

    def one(val: Interval, slot: str = "Out") -> Dict[str, Interval]:
        names = op.output(slot)
        return {names[0]: val} if names else {}

    t = op.type
    a = op.attrs

    # -- constants ---------------------------------------------------------
    if t in ("fill_constant", "fill_constant_batch_size_like"):
        return one(_slop(_pt(float(a.get("value", 0.0)))))
    if t in ("fill_zeros_like", "zeros_like"):
        return one(_pt(0.0))
    if t == "one_hot":
        return one(_UNIT)

    # -- range-bounded activations ----------------------------------------
    if t == "relu":
        v = iv("X")
        return one(Interval(max(0.0, v.lo), max(0.0, v.hi)))
    if t == "relu6":
        v = iv("X")
        thr = float(a.get("threshold", 6.0))
        return one(Interval(min(max(0.0, v.lo), thr),
                            min(max(0.0, v.hi), thr)))
    if t in ("sigmoid", "hard_sigmoid", "softmax", "log_softmax"):
        if t == "log_softmax":
            return one(Interval(-_INF, 0.0))
        return one(_UNIT)
    if t in ("tanh", "softsign", "erf", "sin", "cos", "stanh"):
        return one(_SYM_UNIT)
    if t == "sign":
        return one(_SYM_UNIT)
    if t == "gelu":
        v = iv("X")
        return one(_slop(Interval(0.0 if v.lo >= 0 else -0.2,
                                  max(v.hi, 0.0))))
    if t == "leaky_relu":
        v = iv("X")
        alpha = float(a.get("alpha", 0.02))
        cands = [v.lo, v.hi, _mul_bound(v.lo, alpha), _mul_bound(v.hi, alpha)]
        return one(_slop(Interval(min(min(cands), 0.0),
                                  max(max(cands), 0.0))))
    if t == "clip":
        v = iv("X")
        lo, hi = float(a.get("min", -1.0)), float(a.get("max", 1.0))
        return one(Interval(min(max(v.lo, lo), hi), max(min(v.hi, hi), lo)))
    if t == "abs":
        return one(_abs_iv(iv("X")))
    if t == "square":
        m = _abs_iv(iv("X"))
        return one(_slop(Interval(_mul_bound(m.lo, m.lo),
                                  _mul_bound(m.hi, m.hi))))
    if t == "exp":
        v = iv("X")
        return one(_slop(Interval(_safe_exp(v.lo), _safe_exp(v.hi))))

    # -- domain hazards (PT905) -------------------------------------------
    if t in ("log", "log2", "log10"):
        v = iv("X")
        if v.known and v.lo <= 0.0:
            _diag(diags, "PT905",
                  f"'{t}' on interval [{v.lo:g}, {v.hi:g}] — the operand "
                  f"can be <= 0, producing -inf/nan (guard with clip or "
                  f"+eps to narrow the interval)", block, op_idx, op)
        if v.lo > 0.0:
            return one(_slop(Interval(math.log(v.lo), math.log(v.hi)
                                      if v.hi < _INF else _INF)))
        return one(TOP)
    if t == "sqrt":
        v = iv("X")
        if v.known and v.lo < 0.0:
            _diag(diags, "PT905",
                  f"'sqrt' on interval [{v.lo:g}, {v.hi:g}] — the operand "
                  f"can be negative, producing nan", block, op_idx, op)
        return one(_slop(Interval(
            math.sqrt(max(v.lo, 0.0)) if v.lo > 0 else 0.0,
            math.sqrt(v.hi) if 0 <= v.hi < _INF else _INF)))
    if t == "rsqrt":
        v = iv("X")
        if v.known and v.lo <= 0.0:
            _diag(diags, "PT905",
                  f"'rsqrt' on interval [{v.lo:g}, {v.hi:g}] — the operand "
                  f"can be <= 0, producing inf/nan", block, op_idx, op)
        if v.lo > 0.0:
            return one(_slop(Interval(
                1.0 / math.sqrt(v.hi) if v.hi < _INF else 0.0,
                1.0 / math.sqrt(v.lo))))
        return one(_NON_NEG if v.lo >= 0.0 else TOP)
    if t in ("reciprocal", "elementwise_div"):
        den = iv("Y") if t == "elementwise_div" else iv("X")
        num = iv("X") if t == "elementwise_div" else _pt(1.0)
        if den.known and den.contains_zero():
            _diag(diags, "PT905",
                  f"'{t}' denominator interval [{den.lo:g}, {den.hi:g}] "
                  f"contains 0 — division can produce inf/nan (guard the "
                  f"denominator with clip/abs/+eps)", block, op_idx, op)
        if den.lo > 0.0 or den.hi < 0.0:
            inv = Interval(min(1.0 / den.lo, 1.0 / den.hi),
                           max(1.0 / den.lo, 1.0 / den.hi)) \
                if den.absmax < _INF and den.lo != 0 and den.hi != 0 \
                else TOP
            if t == "reciprocal":
                return one(_slop(inv))
            return one(_slop(_iv_mul(num, inv)))
        return one(TOP)

    # -- linear / elementwise ---------------------------------------------
    if t == "scale":
        v = iv("X")
        s, b = float(a.get("scale", 1.0)), float(a.get("bias", 0.0))
        if a.get("bias_after_scale", True):
            return one(_slop(v.scaled(s).shifted(b)))
        return one(_slop(v.shifted(b).scaled(s)))
    if t == "elementwise_add":
        return one(_slop(_iv_add(iv("X"), iv("Y"))))
    if t == "elementwise_sub":
        return one(_slop(_iv_sub(iv("X"), iv("Y"))))
    if t == "elementwise_mul":
        return one(_slop(_iv_mul(iv("X"), iv("Y"))))
    if t == "elementwise_max":
        vx, vy = iv("X"), iv("Y")
        return one(Interval(max(vx.lo, vy.lo), max(vx.hi, vy.hi)))
    if t == "elementwise_min":
        vx, vy = iv("X"), iv("Y")
        return one(Interval(min(vx.lo, vy.lo), min(vx.hi, vy.hi)))
    if t == "sum":
        _check_low_precision_accum(block, op, diags, op_idx, width=None)
        acc = _pt(0.0)
        for n in op.input("X"):
            acc = _iv_add(acc, env.get(n, TOP))
        return one(_slop(acc, width=len(op.input("X"))))

    # -- reductions (PT903) ------------------------------------------------
    if t in ("mean", "reduce_mean", "reduce_max", "reduce_min", "pool2d"):
        slot = "X"
        width = _static_width(_var_shape(block, op.input(slot)[0])) \
            if op.input(slot) else None
        if t in ("mean", "reduce_mean"):
            _check_low_precision_accum(block, op, diags, op_idx, width)
        # a mean/avg-pool stays inside its input's hull in the reals, but
        # accumulates in float — width-scaled slack; max/min-pool is exact
        return one(_slop(iv(slot), width=width or 1))
    if t == "reduce_sum":
        names = op.input("X")
        shape = _var_shape(block, names[0]) if names else None
        axes = None if a.get("reduce_all") else a.get("dim", [0])
        width = _static_width(shape, axes)
        _check_low_precision_accum(block, op, diags, op_idx, width)
        v = iv("X")
        if width is None:
            if v.lo == 0.0 and v.hi == 0.0:
                return one(_pt(0.0))
            return one(TOP)
        return one(_slop(Interval(_mul_bound(min(v.lo, 0.0), width),
                                  _mul_bound(max(v.hi, 0.0), width)),
                         width=width))
    if t == "squared_l2_norm":
        _check_low_precision_accum(block, op, diags, op_idx, None)
        return one(_NON_NEG)
    if t == "layer_norm":
        width = _static_width(_var_shape(block, op.input("X")[0])) \
            if op.input("X") else None
        _check_low_precision_accum(block, op, diags, op_idx, width,
                                   out_slot="Y")
        res = one(TOP, "Y")
        if op.output("Mean"):
            res[op.output("Mean")[0]] = iv("X")
        if op.output("Variance"):
            res[op.output("Variance")[0]] = _NON_NEG
        return res

    # -- casts (PT902) -----------------------------------------------------
    if t == "cast":
        v = iv("X")
        dst = str(a.get("out_dtype", "float32"))
        fmax = DTYPE_FINITE_MAX.get(dst)
        if fmax is not None and v.known and v.absmax > fmax:
            _diag(diags, "PT902",
                  f"cast to {dst}: statically-proven interval "
                  f"[{v.lo:g}, {v.hi:g}] exceeds the dtype's finite range "
                  f"(±{fmax:g}) — overflow to inf (float) or wraparound "
                  f"(int)", block, op_idx, op)
            return one(TOP)
        if dst.startswith("int") or dst.startswith("uint"):
            return one(Interval(math.floor(v.lo) if v.lo > -_INF else -_INF,
                                math.ceil(v.hi) if v.hi < _INF else _INF))
        # storing into a narrower float rounds: widen by the target's ulp
        rel = _CAST_REL.get(dst, 0.0)
        if rel and v.known:
            v = Interval(v.lo - abs(v.lo) * rel - _ABS_SLACK,
                         v.hi + abs(v.hi) * rel + _ABS_SLACK)
        return one(v)

    # -- GEMM / conv magnitude growth -------------------------------------
    if t in QUANT_SITE_TYPES:
        slots = ("Input", "Filter") if t.endswith("conv2d") else ("X", "Y")
        va, vb = iv(slots[0]), iv(slots[1])
        k = _contraction_width(block, op)
        if k is not None and va.absmax < _INF and vb.absmax < _INF:
            m = _mul_bound(_mul_bound(va.absmax, vb.absmax), float(k))
            return {n: _slop(_sym(m), width=k) for n in op.output("Out") or
                    op.output("Output")}
        return {}

    # -- losses / metrics --------------------------------------------------
    if t == "softmax_with_cross_entropy":
        res = {}
        if op.output("Softmax"):
            res[op.output("Softmax")[0]] = _UNIT
        if op.output("Loss"):
            res[op.output("Loss")[0]] = _NON_NEG
        return res
    if t == "cross_entropy":
        return one(_NON_NEG, "Y") if op.output("Y") else one(_NON_NEG)
    if t == "accuracy":
        res = {}
        for slot in ("Accuracy", "Correct", "Total"):
            if op.output(slot):
                res[op.output(slot)[0]] = _NON_NEG if slot != "Accuracy" \
                    else _UNIT
        return res
    if t == "square_error_cost":
        return one(_NON_NEG)

    # -- quantization ------------------------------------------------------
    if t == "fake_quantize_dequantize_abs_max":
        v = iv("X")
        res = {}
        if op.output("Out"):
            res[op.output("Out")[0]] = _slop(_sym(v.absmax)) \
                if v.absmax < _INF else TOP
        if op.output("OutScale"):
            res[op.output("OutScale")[0]] = _slop(Interval(
                0.0, v.absmax)) if v.absmax < _INF else _NON_NEG
        return res
    if t == "fake_quantize_dequantize_moving_average_abs_max":
        res = {}
        if op.output("Out"):
            res[op.output("Out")[0]] = TOP   # bounded by runtime state
        if op.output("OutScale"):
            res[op.output("OutScale")[0]] = _NON_NEG
        return res

    # -- structure-preserving ops -----------------------------------------
    if t in ("reshape", "reshape2", "squeeze", "squeeze2", "unsqueeze",
             "unsqueeze2", "flatten", "flatten2", "transpose", "transpose2",
             "assign", "share_data", "cast_identity", "pad", "pad2d"):
        v = iv("X")
        if t.startswith("pad"):
            v = v.hull(_pt(float(a.get("pad_value", 0.0))))
        res = one(v)
        # XShape echoes stay TOP (never materialized)
        return res
    if t == "concat":
        acc = None
        for n in op.input("X"):
            cur = env.get(n, TOP)
            acc = cur if acc is None else acc.hull(cur)
        return one(acc if acc is not None else TOP)
    if t == "split":
        v = iv("X")
        return {n: v for n in op.output("Out")}
    if t == "dropout":
        v = iv("X")
        p = float(a.get("dropout_prob", 0.5))
        f = 1.0 / (1.0 - p) if p < 1.0 else 1.0
        scaled = _slop(v.scaled(f).hull(v).hull(_pt(0.0)))
        res = one(scaled)
        if op.output("Mask"):
            res[op.output("Mask")[0]] = Interval(0.0, max(f, 1.0))
        return res
    if t in ("lookup_table", "lookup_table_v2", "embedding", "gather"):
        w = iv("W") if op.input("W") else iv("X")
        return one(w)

    return {}


def _check_low_precision_accum(block, op, diags, op_idx,
                               width: Optional[int],
                               out_slot: str = "Out") -> None:
    """PT903: a reduce-family op whose input AND output are float16/bf16 —
    the accumulation happens in the storage precision with no upcast."""
    in_names = [n for ns in op.inputs.values() for n in ns if n != EMPTY]
    out_names = op.output(out_slot) or op.output_arg_names
    if not in_names or not out_names:
        return
    in_dt = _var_dtype(block, in_names[0])
    out_dt = _var_dtype(block, out_names[0])
    if in_dt in LOW_PRECISION_DTYPES and out_dt in LOW_PRECISION_DTYPES:
        w = f"width {width}" if width else "dynamic width"
        _diag(diags, "PT903",
              f"'{op.type}' accumulates a {in_dt} input into a {out_dt} "
              f"output ({w}) with no upcast — each partial sum rounds to "
              f"{out_dt}; cast to float32 around the reduction",
              block, op_idx, op)


# ---------------------------------------------------------------------------
# whole-program checks
# ---------------------------------------------------------------------------

def _consumers(block) -> Dict[str, List[Tuple[int, object]]]:
    by_name: Dict[str, List[Tuple[int, object]]] = {}
    for i, op in enumerate(block.ops):
        for n in op.input_arg_names:
            if n != EMPTY:
                by_name.setdefault(n, []).append((i, op))
    return by_name


def _check_quant_contract(block, consumers, fetch_names, is_training,
                          diags) -> None:
    """PT900 (pairing) + PT901 (moving-average scale state)."""
    fetched = set(fetch_names)
    for i, op in enumerate(block.ops):
        if op.type not in FAKE_QUANT_TYPES:
            continue
        out_names = op.output("Out")
        if not out_names:
            continue
        q = out_names[0]
        readers = [(j, c) for j, c in consumers.get(q, ()) if c is not op]
        if not readers and q not in fetched:
            _diag(diags, "PT900",
                  f"fake-quant output '{q}' is never consumed and not "
                  f"fetched — the quantized value (and its scale) is dead",
                  block, i, op)
        for _j, c in readers:
            if c.type in QUANT_CONSUMER_TYPES or c.type.endswith("_grad") \
                    or c.type in FAKE_QUANT_TYPES:
                continue
            _diag(diags, "PT900",
                  f"fake-quant output '{q}' is consumed by '{c.type}' — "
                  f"the int8 rewrite contract only holds for GEMM/conv "
                  f"consumers ({', '.join(sorted(QUANT_CONSUMER_TYPES))}); "
                  f"an off-path consumer would read dequantized values the "
                  f"int8 lowering cannot reproduce", block, i, op)
        if op.type == "fake_quantize_dequantize_moving_average_abs_max" \
                and is_training:
            scales = op.output("OutScale")
            in_scales = op.input("InScale")
            if scales:
                s = scales[0]
                v = _find_var(block, s)
                if v is not None and not getattr(v, "persistable", False):
                    _diag(diags, "PT901",
                          f"moving-average scale '{s}' is not persistable "
                          f"in a training program — the running scale "
                          f"resets every step and the QAT calibration "
                          f"never converges", block, i, op)
                if in_scales and in_scales[0] != EMPTY \
                        and in_scales[0] != s:
                    _diag(diags, "PT901",
                          f"moving-average scale state is not updated in "
                          f"place: InScale '{in_scales[0]}' != OutScale "
                          f"'{s}' — the updated scale is never read back, "
                          f"so the moving average never advances",
                          block, i, op)


def _check_amp_coverage(block, diags) -> bool:
    """PT904: loss scaling active but a grad skips unscale. Returns
    whether scaling is active (for the report)."""
    unscaled: Set[str] = set()
    for op in block.ops:
        if op.type == "check_finite_and_unscale":
            unscaled.update(n for n in op.input("X") if n != EMPTY)
            unscaled.update(n for n in op.output("Out") if n != EMPTY)
    if not unscaled:
        return False
    for i, op in enumerate(block.ops):
        if _role(op) != OpRole.Optimize:
            continue
        for g in op.input("Grad"):
            if g != EMPTY and g not in unscaled:
                _diag(diags, "PT904",
                      f"gradient '{g}' reaches '{op.type}' without "
                      f"passing through check_finite_and_unscale while "
                      f"loss scaling is active — the update applies a "
                      f"scaled gradient (wrong by the loss-scale factor)",
                      block, i, op)
    return True


def _quant_report(block, env, calibration, diags,
                  sites: List[dict]) -> None:
    """PT906: one info finding + work-list entry per forward GEMM/conv
    site (an int8 lowering's input)."""
    produced_by: Dict[str, object] = {}
    for op in block.ops:
        for n in op.output_arg_names:
            if n != EMPTY:
                produced_by[n] = op
    for i, op in enumerate(block.ops):
        if op.type not in QUANT_SITE_TYPES or _role(op) != OpRole.Forward:
            continue
        slots = ("Input", "Filter") if op.type.endswith("conv2d") \
            else ("X", "Y")
        in_names = [op.input(s)[0] for s in slots if op.input(s)]
        quant_annotated = bool(in_names) and all(
            getattr(produced_by.get(n), "type", "") in FAKE_QUANT_TYPES
            for n in in_names)
        out_names = op.output("Out") or op.output("Output")
        out_name = out_names[0] if out_names else ""
        k = _contraction_width(block, op)
        static_absmax = None
        iv = env.get(out_name, TOP)
        if iv.absmax < _INF:
            static_absmax = iv.absmax
        calib = {n: calibration[n] for n in in_names + [out_name]
                 if n in calibration}
        sites.append({
            "block": block.idx, "op_idx": i, "op_type": op.type,
            "out": out_name, "inputs": dict(zip(slots, in_names)),
            "contraction_width": k, "quant_annotated": quant_annotated,
            "static_absmax": static_absmax,
            "calibrated_absmax": calib or None,
        })
        _diag(diags, "PT906",
              f"quantizable {op.type} site -> '{out_name}' "
              f"(K={k if k is not None else '?'}, "
              f"quant-annotated={'yes' if quant_annotated else 'no'}"
              + (f", observed |x|max={max(calib.values()):g}" if calib
                 else "") + ") — int8 epilogue lowering candidate",
              block, i, op)


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def analyze_numerics(program, fetch_names: Sequence[str] = (),
                     calibration: Optional[Dict[str, float]] = None
                     ) -> NumericsReport:
    """The full walk, free of any PassContext (the witness cross-check and
    the tests call this directly; the registered pass wraps it)."""
    calibration = dict(calibration or {})
    rep = NumericsReport()
    rep.is_training = any(
        _role(op) in (OpRole.Backward, OpRole.Optimize)
        for blk in program.blocks for op in blk.ops)
    env: Dict[str, Interval] = rep.intervals

    # calibration seeds (observed abs-max — tracked, never "proven")
    for name, v in calibration.items():
        if isinstance(v, (tuple, list)) and len(v) == 2:
            env[name] = Interval(float(v[0]), float(v[1]))
        else:
            env[name] = _sym(float(v))
        rep.calibrated.add(name)

    for blk in program.blocks:
        consumers = _consumers(blk)
        for i, op in enumerate(blk.ops):
            try:
                outs = _transfer(blk, op, env, rep.diagnostics, i)
            except Exception:
                outs = {}
            for n in op.output_arg_names:
                if n == EMPTY:
                    continue
                new = outs.get(n, TOP)
                # taint: any output derived from a calibrated input is
                # itself calibrated (observed, not proven)
                if new.known and any(
                        m in rep.calibrated for m in op.input_arg_names
                        if m != EMPTY):
                    rep.calibrated.add(n)
                env[n] = new
        _check_quant_contract(blk, consumers, fetch_names,
                              rep.is_training, rep.diagnostics)
        if _check_amp_coverage(blk, rep.diagnostics):
            rep.loss_scaling_active = True
        _quant_report(blk, env, calibration, rep.diagnostics,
                      rep.quant_sites)
    return rep


def check_numerics(program, ctx) -> NumericsReport:
    """The registered ``numerics_check`` analysis pass: reports the PT900
    family on the context and caches the :class:`NumericsReport`.
    Options: ``numerics_calibration`` — {var: observed absmax} (or
    ``(min, max)``), fed back from the runtime witness."""
    rep = analyze_numerics(
        program, fetch_names=ctx.fetch_names,
        calibration=ctx.options.get("numerics_calibration"))
    for d in rep.diagnostics:
        ctx.report(d)
    return rep


def static_intervals(program, fetch_names: Sequence[str] = ()
                     ) -> Dict[str, Tuple[float, float]]:
    """Proven (calibration-free) bounded intervals by var name — the
    witness containment contract surface
    (``monitor.numwitness.containment_violations`` asserts every observed
    value lies inside, tolerance-free)."""
    return analyze_numerics(program,
                            fetch_names=fetch_names).bounded_intervals()
