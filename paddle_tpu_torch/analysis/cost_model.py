"""Static FLOP / byte cost model over the Program IR (pass ``cost_model``),
the counterpart of ``paddle_tpu/analysis/cost_model.py``.

Measured TF/s means something only against the program's MODEL FLOPs;
this pass derives them from the ``infer_shape`` metadata already recorded
on every var at build time — no execution, one walk over the ops.

Convention: **one multiply-add = 2 FLOPs** (the 6ND convention).
Matmul-class ops are exact MAC counts; normalization/activation/optimizer
ops use small per-element constants (they are <2% of any matmul-bearing
program); unknown ops default to one FLOP per output element. Backward ops
of the matmul class cost exactly 2x their forward (dgrad + wgrad),
computed from the forward slots the grad op carries. ``recompute_segment``
costs 0 and its grad 1 FLOP an output element, as in the JAX package, so
a rematerialised program's cost undercounts its backward: take model FLOPs
from the untransformed program.

Consumers:

* ``monitor`` caches one :class:`CostReport` per (program, batch) and
  turns measured step durations into ``executor_mfu`` / achieved-TF/s
  gauges (per program serial and batch), against
  ``FLAGS_device_peak_tflops`` (the H100 SXM's dense bf16 peak by
  default);
* ``ServingEngine`` emits the same per bucket after every batch;
* registered as analysis pass ``cost_model`` so pipelines can require it
  (``ctx.analysis("cost_model")``).

The comms half (``estimate_comms``, ``CommsReport``,
``comms_compute_ratio``) turns ``analysis/sharding_check.py``'s collective
events into per-rank wire bytes and a predicted comms-vs-compute ratio
against ``FLAGS_ici_gbytes_per_s`` (the link between ranks: NVLink, or
the host for ranks that share a card).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from ..core import registry
from .liveness import _var_bytes

__all__ = ["CostReport", "estimate_cost", "op_flops", "check_cost_model",
           "MATMUL_CLASS", "CommsReport", "estimate_comms",
           "comms_compute_ratio"]

EMPTY = "@EMPTY@"

# ops whose grads cost exactly 2x forward (dgrad + wgrad / dQKV)
MATMUL_CLASS = frozenset({"conv2d", "mul", "matmul",
                          "fused_multihead_attention"})

# small per-element constants for the non-matmul tail (normalizations,
# activations with transcendentals, optimizers). Deliberately coarse:
# on any matmul-bearing program these are noise; chip_smoke.py's
# train_remat phase prints BERT-base's cost against the analytic 6ND +
# attention count.
_PER_ELEM = {
    "relu": 1, "relu6": 1, "leaky_relu": 2, "sigmoid": 4, "tanh": 6,
    "gelu": 10, "swish": 5, "elu": 3, "softplus": 4, "softsign": 2,
    "exp": 4, "log": 4, "sqrt": 2, "rsqrt": 2, "square": 1, "abs": 1,
    "scale": 2, "cast": 1, "dropout": 2, "softmax": 5,
    "batch_norm": 5, "layer_norm": 8, "instance_norm": 8,
    "group_norm": 8, "softmax_with_cross_entropy": 7,
    "cross_entropy": 3, "cross_entropy2": 3, "mean": 1, "sum": 1,
    "momentum": 4, "sgd": 2, "adam": 12, "adamax": 8, "adagrad": 6,
    "rmsprop": 8, "lars_momentum": 8,
}


@dataclasses.dataclass
class CostReport:
    """Per-program static cost at one batch size."""

    batch_size: int
    flops_total: float          # fwd + bwd + optimizer, 2 FLOPs per MAC
    flops_forward: float
    flops_backward: float
    flops_optimizer: float      # optimize + lr_sched role ops
    flops_by_op_type: Dict[str, float]
    activation_bytes: int       # non-persistable op outputs, batch-resolved
    param_bytes: int            # persistable vars
    n_ops: int
    unknown_ops: List[str]      # op types costed by the 1-FLOP/elem default

    @property
    def flops_per_byte(self) -> float:
        """Arithmetic intensity against activations + params (the
        roofline x-axis; a coarse lower bound — reuse within fused
        regions only helps)."""
        denom = self.activation_bytes + self.param_bytes
        return self.flops_total / denom if denom else 0.0

    def mfu(self, seconds_per_step: float,
            peak_tflops: Optional[float] = None) -> float:
        """Model FLOP utilisation of one measured step."""
        if peak_tflops is None:
            from ..flags import flag

            peak_tflops = float(flag("device_peak_tflops"))
        if seconds_per_step <= 0 or peak_tflops <= 0:
            return 0.0
        return self.flops_total / seconds_per_step / (peak_tflops * 1e12)

    def to_dict(self) -> dict:
        top = sorted(self.flops_by_op_type.items(),
                     key=lambda kv: -kv[1])[:12]
        return {"batch_size": self.batch_size,
                "flops_total": self.flops_total,
                "flops_forward": self.flops_forward,
                "flops_backward": self.flops_backward,
                "flops_optimizer": self.flops_optimizer,
                "gflops_total": round(self.flops_total / 1e9, 3),
                "flops_by_op_type": {k: v for k, v in top},
                "activation_bytes": self.activation_bytes,
                "param_bytes": self.param_bytes,
                "flops_per_byte": round(self.flops_per_byte, 2),
                "n_ops": self.n_ops,
                "unknown_ops": sorted(set(self.unknown_ops))}


# ---------------------------------------------------------------------------
# shape helpers
# ---------------------------------------------------------------------------

def _shape(blk, name: str, batch: int) -> Optional[Tuple[int, ...]]:
    """Recorded (build-time infer_shape) shape with -1 dims resolved to
    ``batch`` — the same resolution rule as ``memory_plan``."""
    if name == EMPTY or not blk.has_var_recursive(name):
        return None
    v = blk._var_recursive(name)
    if v.shape is None:
        return None
    return tuple(int(batch) if int(d) < 0 else int(d) for d in v.shape)


def _numel(shape: Optional[Tuple[int, ...]]) -> int:
    if shape is None:
        return 0
    n = 1
    for d in shape:
        n *= max(int(d), 0)
    return n


def _slot_shape(blk, op, slot: str, batch: int):
    # grad ops carry the forward slots renamed: '__out__Output' (the
    # forward output fed back in) and 'Output@GRAD' share the forward
    # output's shape, so a matmul-class grad can be costed from its own
    # slots without looking up the forward op
    for s in (slot, "__out__" + slot, slot + "@GRAD"):
        names = op.input(s) or op.output(s)
        if names:
            return _shape(blk, names[0], batch)
    return None


def _out_numel(blk, op, batch: int) -> int:
    return sum(_numel(_shape(blk, n, batch))
               for n in op.output_arg_names if n != EMPTY)


# ---------------------------------------------------------------------------
# per-op FLOP rules
# ---------------------------------------------------------------------------

def _flops_conv2d(blk, op, batch: int) -> Optional[float]:
    out = _slot_shape(blk, op, "Output", batch)
    filt = _slot_shape(blk, op, "Filter", batch)
    if out is None or filt is None or len(filt) < 4:
        return None
    groups = max(1, int(op.attrs.get("groups") or 1))
    # Filter is [Co, Cin/groups, kh, kw]: macs per output element =
    # (Cin/groups)*kh*kw; groups is already folded into the filter shape
    macs_per_out = filt[1] * filt[2] * filt[3]
    del groups
    return 2.0 * _numel(out) * macs_per_out


def _flops_mul(blk, op, batch: int) -> Optional[float]:
    x = _slot_shape(blk, op, "X", batch)
    y = _slot_shape(blk, op, "Y", batch)
    if x is None or y is None:
        return None
    a = int(op.attrs.get("x_num_col_dims") or 1)
    b = int(op.attrs.get("y_num_col_dims") or 1)
    m = _numel(x[:a])
    k = _numel(x[a:])
    n = _numel(y[b:])
    return 2.0 * m * k * n


def _flops_matmul(blk, op, batch: int) -> Optional[float]:
    x = _slot_shape(blk, op, "X", batch)
    out = _slot_shape(blk, op, "Out", batch)
    if x is None or out is None or not x:
        return None
    k = x[-2] if op.attrs.get("transpose_X") else x[-1]
    return 2.0 * _numel(out) * int(k)


def _flops_attention(blk, op, batch: int) -> Optional[float]:
    q = _slot_shape(blk, op, "Q", batch)
    k = _slot_shape(blk, op, "K", batch)
    if q is None or len(q) < 4:
        return None
    b, h, s_q, dh = q[-4], q[-3], q[-2], q[-1]
    s_k = k[-2] if k is not None and len(k) >= 2 else s_q
    # QK^T (2*b*h*s_q*s_k*dh) + PV (2*b*h*s_q*s_k*dh); causal masking
    # halves the useful work but the kernel still computes the tiles, so
    # count the full rectangle (this is a COST model, not a utility one)
    return 4.0 * b * h * s_q * s_k * dh


_MATMUL_RULES = {
    "conv2d": _flops_conv2d,
    "depthwise_conv2d": _flops_conv2d,
    "mul": _flops_mul,
    "matmul": _flops_matmul,
    "fused_multihead_attention": _flops_attention,
}


def op_flops(blk, op, batch: int) -> Tuple[float, bool]:
    """(flops, known_rule) for one op at ``batch``. Grad ops of the
    matmul class cost 2x their forward rule computed from the forward
    slots the grad op carries; other grads and unknown ops default to
    one FLOP per output element."""
    t = op.type
    if t in ("feed", "fetch", "fill_constant", "lookup_table",
             "lookup_table_grad", "shape", "recompute_segment"):
        return 0.0, True
    if t in _MATMUL_RULES:
        f = _MATMUL_RULES[t](blk, op, batch)
        if f is not None:
            return f, True
        return float(_out_numel(blk, op, batch)), False
    if t.endswith("_grad"):
        base = t[:-5]
        if base in _MATMUL_RULES:
            f = _MATMUL_RULES[base](blk, op, batch)
            if f is not None:
                return 2.0 * f, True
        c = _PER_ELEM.get(base)
        if c is not None:
            return float(c) * _out_numel(blk, op, batch), True
        # grads of registered ops: 1 FLOP per grad-output element is a
        # fair default (elementwise/view grads); unregistered stay unknown
        return (float(_out_numel(blk, op, batch)),
                registry.has_op(base))
    c = _PER_ELEM.get(t)
    if c is not None:
        return float(c) * _out_numel(blk, op, batch), True
    if t == "pool2d":
        out = _slot_shape(blk, op, "Out", batch)
        x = _slot_shape(blk, op, "X", batch)
        if op.attrs.get("global_pooling"):
            return float(_numel(x)), True
        ks = op.attrs.get("ksize") or op.attrs.get("pool_size") or 1
        kk = _numel(tuple(ks)) if isinstance(ks, (list, tuple)) else int(ks)
        return float(_numel(out)) * max(1, kk), True
    return float(_out_numel(blk, op, batch)), registry.has_op(t)


# ---------------------------------------------------------------------------
# the program walk
# ---------------------------------------------------------------------------

def estimate_cost(program, batch_size: int = 1) -> CostReport:
    """One :class:`CostReport` for the global block at ``batch_size``
    (sub-block ops — while/cond bodies — are counted once; the model has
    no trip counts, and none of the zoo's hot programs loop)."""
    from ..framework import OpRole

    batch = max(1, int(batch_size))
    by_type: Dict[str, float] = {}
    fwd = bwd = opt = 0.0
    unknown: List[str] = []
    n_ops = 0
    act_bytes = 0
    seen_out: set = set()
    for blk in program.blocks:
        for op in blk.ops:
            if op.type in ("feed", "fetch"):
                continue
            n_ops += 1
            f, known = op_flops(blk, op, batch)
            if not known:
                unknown.append(op.type)
            if f:
                by_type[op.type] = by_type.get(op.type, 0.0) + f
                role = op.attrs.get("__op_role__", OpRole.Forward)
                if role == OpRole.Backward:
                    bwd += f
                elif role in (OpRole.Optimize, OpRole.LRSched):
                    opt += f
                else:
                    fwd += f
            for name in op.output_arg_names:
                if name == EMPTY or name in seen_out \
                        or not blk.has_var(name):
                    continue
                seen_out.add(name)
                v = blk.var(name)
                if not v.persistable:
                    act_bytes += _var_bytes(v, batch)[0]
    param_bytes = sum(_var_bytes(v, batch)[0]
                      for b in program.blocks
                      for v in b.vars.values() if v.persistable)
    return CostReport(batch_size=batch, flops_total=fwd + bwd + opt,
                      flops_forward=fwd, flops_backward=bwd,
                      flops_optimizer=opt, flops_by_op_type=by_type,
                      activation_bytes=int(act_bytes),
                      param_bytes=int(param_bytes), n_ops=n_ops,
                      unknown_ops=unknown)


def check_cost_model(program, ctx) -> CostReport:
    """The registered ``cost_model`` analysis pass body: estimate at the
    context's batch size; the report is cached on the PassContext
    (``ctx.analysis("cost_model")``). Reports no diagnostics — cost is
    information, not a finding."""
    return estimate_cost(program, batch_size=ctx.batch_size)


# ---------------------------------------------------------------------------
# per-op collective volumes (from sharding_check spec transitions)
# ---------------------------------------------------------------------------

# per-chip wire bytes of one collective over an axis of size n, as a
# fraction of the FULL tensor bytes (ring algorithms):
#   all_reduce     2*(n-1)/n   (reduce-scatter + all-gather)
#   all_gather       (n-1)/n
#   reduce_scatter   (n-1)/n
#   reshard          (n-1)/n   (all-to-all-class layout change, upper bound)
def _wire_fraction(kind: str, n: int) -> float:
    if n <= 1:
        return 0.0
    f = (n - 1) / n
    return 2.0 * f if kind == "all_reduce" else f


@dataclasses.dataclass
class CommsReport:
    """Per-chip collective wire volume of one step under a sharding
    assignment (derived from ``sharding_check`` spec transitions — the
    static face of the AllReduceOpHandles the reference builder placed
    by hand)."""

    mesh: Dict[str, int]
    events: List[dict]              # CollectiveEvent.to_dict + wire bytes
    wire_bytes_by_kind: Dict[str, int]
    total_wire_bytes: int           # per chip, per step

    @property
    def gbytes_per_step(self) -> float:
        return self.total_wire_bytes / 1e9

    def comms_seconds(self, ici_gbytes_per_s: Optional[float] = None
                      ) -> float:
        """Predicted time on the wire per step (per chip), against the
        effective link bandwidth between ranks (``FLAGS_ici_gbytes_per_s``)."""
        if ici_gbytes_per_s is None:
            from ..flags import flag

            ici_gbytes_per_s = float(flag("ici_gbytes_per_s"))
        if ici_gbytes_per_s <= 0:
            return 0.0
        return self.total_wire_bytes / (ici_gbytes_per_s * 1e9)

    def to_dict(self) -> dict:
        return {"mesh": dict(self.mesh),
                "total_wire_bytes_per_chip": self.total_wire_bytes,
                "gbytes_per_step": round(self.gbytes_per_step, 6),
                "wire_bytes_by_kind": dict(self.wire_bytes_by_kind),
                "events": self.events}


def estimate_comms(analysis) -> CommsReport:
    """Convert a :class:`sharding_check.ShardingAnalysis`'s collective
    events into per-chip wire volumes."""
    mesh = dict(analysis.mesh)
    by_kind: Dict[str, int] = {}
    events: List[dict] = []
    total = 0
    for ev in analysis.collectives:
        n = ev.axis_size(mesh)
        wire = int(ev.bytes_full * _wire_fraction(ev.kind, n))
        d = ev.to_dict()
        d["wire_bytes_per_chip"] = wire
        events.append(d)
        by_kind[ev.kind] = by_kind.get(ev.kind, 0) + wire
        total += wire
    return CommsReport(mesh=mesh, events=events,
                       wire_bytes_by_kind=by_kind, total_wire_bytes=total)


def comms_compute_ratio(comms: CommsReport, cost: CostReport,
                        peak_tflops: Optional[float] = None,
                        ici_gbytes_per_s: Optional[float] = None) -> float:
    """Predicted comms-vs-compute ratio of one step: time on the wire over
    time in the tensor cores, both per rank (compute FLOPs divide by the mesh's
    device count — the data-parallel split; >1.0 means the step is
    predicted communication-bound)."""
    if peak_tflops is None:
        from ..flags import flag

        peak_tflops = float(flag("device_peak_tflops"))
    n_dev = 1
    for s in comms.mesh.values():
        n_dev *= int(s)
    if peak_tflops <= 0 or cost.flops_total <= 0:
        return 0.0
    compute_s = (cost.flops_total / max(n_dev, 1)) / (peak_tflops * 1e12)
    if compute_s <= 0:
        return 0.0
    return comms.comms_seconds(ici_gbytes_per_s) / compute_s
