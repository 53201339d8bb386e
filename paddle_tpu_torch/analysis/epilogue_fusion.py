"""GEMM-epilogue fusion as a registered transform pass (counterpart of
``paddle_tpu/analysis/epilogue_fusion.py``).

Matched ``mul``/``matmul`` -> bias-add -> activation -> residual-add ->
layer_norm chains rewrite into ONE ``fused_gemm_epilogue`` op
(ops/fused_gemm.py), whose CUDA route runs the fused-GEMM kernel K5 with
the whole epilogue on its f32 accumulator (kernels/fused_gemm.py) and
whose dense route replays the original op rules bit-exactly.

Safety model: refuse, never a wrong program.

* **Structural gates** (per chain, via the cached liveness analysis):
  every intermediate must have exactly ONE consumer (the next chain op),
  must not be fetched, persistable, fed, or read from a sub-block; the
  chain order must be exactly the kernel's epilogue order
  (bias -> activation -> residual -> layer_norm). layer_norm's
  Mean/Variance outputs must be dead; a non-chain op between the chain's
  ops must not rewrite a var the chain reads (PT756).
* **Program gate**: any backward/optimize/lr op refuses the whole program
  (PT753): the fused op registers ``grad=None``.
* **Fidelity witness** (PT754): for every distinct chain signature the
  original ops and the fused op are BOTH executed over seeded numpy inputs
  through the real op rules, ON THE EXECUTOR'S DEVICE (``options["device"]``
  of the pass context), so on the card the witness holds K5 itself against
  the unfused chain on cuBLAS. Exact bits on the dense route, the declared
  per-dtype tolerance on the kernel route. Any mismatch refuses the
  entire program. The largest error per signature is kept on the
  decision (``FusionDecision.witness``).

The rewritten program is a fresh ``Program`` (own ``_serial``), so caches
keyed on the program never alias fused and plain variants. Wiring:
``Executor._maybe_epilogue_fusion`` under ``FLAGS_epilogue_fusion``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.types import canonical_dtype, torch_dtype
from ..framework import OpRole, Program
from .diagnostics import Diagnostic
from .verifier import EMPTY, _site

__all__ = [
    "FusedChain", "FusionDecision", "WITNESS_TOLERANCES",
    "find_fusable_chains", "fuse_epilogues", "has_fusable_ops",
    "epilogue_fusion_pass",
]

# declared witness tolerances on the KERNEL route, by compute dtype (the
# JAX package's): the kernel accumulates in f32 and applies the epilogue
# before one final cast, so it may differ from the unfused chain by
# summation order and intermediate rounding. The DENSE route is compared
# with exact bits (tolerance 0) — it replays the original op rules.
WITNESS_TOLERANCES: Dict[str, Tuple[float, float]] = {
    "float32": (2e-4, 1e-5),      # (rtol, atol)
    "bfloat16": (2e-2, 2e-2),
    "float16": (2e-2, 2e-2),
}

_BASE_TYPES = ("mul", "matmul")
_ACT_TYPES = ("relu", "gelu")

# chain stages, in the kernel's fixed epilogue order
_S_BASE, _S_BIAS, _S_ACT, _S_RES = 0, 1, 2, 3


@dataclasses.dataclass
class FusedChain:
    """One matched mul/matmul→epilogue chain (global-block op indices)."""

    op_indices: List[int]            # base first, in program order
    out_name: str                    # the chain's surviving output
    attrs: Dict[str, object]         # fused_gemm_epilogue attrs
    inputs: Dict[str, str]           # slot -> var name (X/Y/Bias/...)
    dead_outputs: List[str]          # e.g. layer_norm Mean/Variance
    epilogue: str                    # human label: 'bias+gelu', ...

    def label(self) -> str:
        return self.epilogue


@dataclasses.dataclass
class FusionDecision:
    """Outcome of one epilogue-fusion attempt. ``witness`` has one entry
    per witnessed chain signature: its first chain's ops, epilogue, GEMM
    dims, route with its reason and the largest absolute difference the
    witness saw."""

    applied: bool
    program: Program                 # transformed, or the original
    reason: str
    n_fused: int = 0
    n_refused: int = 0
    chains: List[dict] = dataclasses.field(default_factory=list)
    witness: List[dict] = dataclasses.field(default_factory=list)

    def to_dict(self) -> dict:
        return {"applied": self.applied, "reason": self.reason,
                "fused": self.n_fused, "refused": self.n_refused,
                "chains": list(self.chains), "witness": list(self.witness)}


def has_fusable_ops(program: Program) -> bool:
    """Cheap pre-filter for the executor hook: a forward-only program with
    at least one mul/matmul. Everything else passes through without paying
    a pipeline run."""
    saw_base = False
    for op in program.global_block.ops:
        if op.attrs.get("__op_role__", OpRole.Forward) != OpRole.Forward:
            return False
        if op.type in _BASE_TYPES:
            saw_base = True
    return saw_base


def _sole_reads(op, name: str) -> bool:
    """The op reads ``name`` through exactly one slot position."""
    return sum(1 for n in op.input_arg_names if n == name) == 1


def _static_shape(var, batch: int = 8):
    if var is None or var.shape is None:
        return None
    return tuple(batch if d == -1 else int(d) for d in var.shape)


def find_fusable_chains(program: Program, live: Dict[str, object],
                        fetch_names: Sequence[str],
                        diags: Optional[List[Diagnostic]] = None
                        ) -> List[FusedChain]:
    """Match fusable chains in the global block.

    ``live`` is the cached liveness analysis' VarLive map — its ``uses``
    lists fold sub-block reads into the owning op's index, so an
    intermediate read inside a while body correctly counts as an extra
    consumer. Refusal diagnostics (PT751/PT752/PT755) are appended to
    ``diags`` for chains that matched the grammar but failed a gate.
    """
    gb = program.global_block
    fetch = {getattr(f, "name", f) for f in (fetch_names or ())}
    diags = diags if diags is not None else []
    claimed: set = set()
    chains: List[FusedChain] = []

    def var(name):
        return gb.vars.get(name)

    def refusal(code, msg, oi, op):
        diags.append(Diagnostic(code, msg, gb.idx, oi, op.type, _site(op)))

    def sole_consumer(name: str, producer_idx: int, op, probe):
        """The single consuming op index, or None with the refusal
        recorded. A PT751 fetch-refusal goes to ``probe``: the caller
        commits it to ``diags`` only when the failure killed a would-be
        chain — when the probe merely fails to EXTEND an already-valid
        chain, the fetched value is the chain's surviving output, which
        the fused op itself writes, so nothing is hidden. PT752
        multi-consumer refusals stay unconditional (they name the real
        reason a downstream epilogue op did not fold in)."""
        if name in fetch:
            probe.append(Diagnostic(
                "PT751",
                f"'{name}' is fetched mid-chain — fusing would hide the "
                f"value the caller asked for", gb.idx, producer_idx,
                op.type, _site(op)))
            return None
        v = var(name)
        if v is None or v.persistable or v.is_data:
            return None
        vl = live.get(name)
        uses = list(getattr(vl, "uses", ())) if vl is not None else []
        if len(uses) != 1:
            refusal("PT752",
                    f"'{name}' has {len(uses)} consumers — an epilogue "
                    f"intermediate must feed exactly the next chain op",
                    producer_idx, op)
            return None
        j = uses[0]
        if j <= producer_idx or j >= len(gb.ops):
            return None
        if not _sole_reads(gb.ops[j], name):
            refusal("PT752",
                    f"op {j} reads '{name}' through more than one slot",
                    producer_idx, op)
            return None
        return j

    for i, base in enumerate(gb.ops):
        if i in claimed or base.type not in _BASE_TYPES:
            continue
        if base.type == "matmul":
            xv, yv = var(base.input("X")[0]), var(base.input("Y")[0])
            if xv is None or yv is None or xv.shape is None \
                    or yv.shape is None or len(xv.shape) != 2 \
                    or len(yv.shape) != 2:
                continue  # batched matmul: not the 2-D GEMM view
        t = base.output("Out")[0]
        out_v = var(t)
        if out_v is None or out_v.shape is None:
            continue
        out_ndim = len(out_v.shape)
        n_dim = out_v.shape[-1]

        stage = _S_BASE
        chain_ops = [i]
        parts: List[str] = []
        inputs = {"X": base.input("X")[0], "Y": base.input("Y")[0]}
        # write-hazard bookkeeping: external inputs remember where the
        # chain first READS them (the fused op moves that read to the
        # chain's last position), intermediates remember their
        # (def, read) window — a non-chain op writing into either window
        # would make the fused rewrite read a different value
        read_at = {inputs["X"]: i, inputs["Y"]: i}
        hazard_windows: List[tuple] = []
        attrs: Dict[str, object] = {
            "base_type": base.type,
            "x_num_col_dims": base.attrs.get("x_num_col_dims", 1),
            "y_num_col_dims": base.attrs.get("y_num_col_dims", 1),
            "transpose_X": base.attrs.get("transpose_X", False),
            "transpose_Y": base.attrs.get("transpose_Y", False),
            "alpha": base.attrs.get("alpha", 1.0),
            "activation": "none", "gelu_approximate": False,
            "bias_axis": -1, "residual_axis": -1,
            "layer_norm": False, "epsilon": 1e-5,
            "begin_norm_axis": out_ndim - 1,
        }
        dead_outputs: List[str] = []
        cur = t
        cur_op = base
        cur_idx = i

        probe: List[Diagnostic] = []
        while True:
            probe.clear()
            j = sole_consumer(cur, cur_idx, cur_op, probe)
            if j is None or j in claimed:
                break
            op = gb.ops[j]
            if op.type == "elementwise_add" and stage < _S_RES \
                    and op.input("X") and op.input("X")[0] == cur:
                other = op.input("Y")[0]
                ov = var(other) or (gb._var_recursive(other)
                                    if gb.has_var_recursive(other) else None)
                oshape = getattr(ov, "shape", None)
                axis = op.attrs.get("axis", -1)
                if (stage == _S_BASE and oshape is not None
                        and len(oshape) == 1 and oshape[0] == n_dim
                        and axis in (-1, out_ndim - 1)):
                    inputs["Bias"] = other
                    read_at.setdefault(other, j)
                    attrs["bias_axis"] = axis
                    parts.append("bias")
                    stage = _S_BIAS
                elif (oshape is not None
                        and tuple(oshape) == tuple(out_v.shape)):
                    inputs["Residual"] = other
                    read_at.setdefault(other, j)
                    attrs["residual_axis"] = axis
                    parts.append("residual")
                    stage = _S_RES
                else:
                    break
            elif op.type in _ACT_TYPES and stage < _S_ACT:
                attrs["activation"] = op.type
                if op.type == "gelu":
                    attrs["gelu_approximate"] = bool(
                        op.attrs.get("approximate", False))
                parts.append(op.type)
                stage = _S_ACT
            elif op.type == "layer_norm" \
                    and op.attrs.get("begin_norm_axis", 1) == out_ndim - 1:
                mean, varn = op.output("Mean")[0], op.output("Variance")[0]
                side = [n for n in (mean, varn) if n != EMPTY]
                blocked = False
                for n in side:
                    sv = var(n)
                    vl = live.get(n)
                    if (n in fetch or (sv is not None and sv.persistable)
                            or (vl is not None and getattr(vl, "uses", ()))):
                        refusal("PT752",
                                f"layer_norm side output '{n}' is consumed "
                                f"— only dead Mean/Variance can fold away",
                                j, op)
                        blocked = True
                if blocked:
                    break
                for s_slot, a_slot in (("Scale", "LnScale"),
                                       ("Bias", "LnBias")):
                    names = op.input(s_slot)
                    if names and names[0] != EMPTY:
                        inputs[a_slot] = names[0]
                        read_at.setdefault(names[0], j)
                attrs["layer_norm"] = True
                attrs["epsilon"] = op.attrs.get("epsilon", 1e-5)
                dead_outputs.extend(side)
                parts.append("layer_norm")
                hazard_windows.append((cur, cur_idx, j))
                chain_ops.append(j)
                cur = op.output("Y")[0]
                break   # terminal epilogue stage
            else:
                break
            hazard_windows.append((cur, cur_idx, j))
            chain_ops.append(j)
            cur = op.output("Out")[0]
            cur_op = op
            cur_idx = j

        if len(chain_ops) < 2:
            # the fetch-probe's failure is what killed the chain — now it
            # is a genuine refusal, not a probe past the surviving output
            diags.extend(probe)
            continue

        # an op BETWEEN the chain's ops that is not a chain member and
        # rewrites (in-place) a var the chain reads: the fused op sits at
        # the chain's LAST position, so its input reads would cross the
        # redefinition — and an intermediate clobbered between its def and
        # its read means the original chain never computed what the fused
        # op recomputes. Either way the rewrite would be numerically wrong:
        # refuse (never a wrong program).
        last = chain_ops[-1]
        member = set(chain_ops)
        windows = hazard_windows + [(nm, ridx, last)
                                    for nm, ridx in read_at.items()]
        clobber = None
        for kdx in range(i + 1, last):
            if kdx in member:
                continue
            writes = set(gb.ops[kdx].output_arg_names)
            hit = [nm for nm, lo, hi in windows
                   if nm in writes and lo < kdx and kdx <= hi]
            if hit:
                clobber = (kdx, hit[0])
                break
        if clobber is not None:
            kdx, nm = clobber
            refusal("PT756",
                    f"'{nm}' is rewritten by op {kdx} "
                    f"('{gb.ops[kdx].type}') between the chain's ops — "
                    f"the fused op at the chain's last position would "
                    f"read the redefined value", i, base)
            continue
        chains.append(FusedChain(
            op_indices=chain_ops, out_name=cur, attrs=attrs, inputs=inputs,
            dead_outputs=dead_outputs, epilogue="+".join(parts)))
        claimed.update(chain_ops)
    return chains


# ---------------------------------------------------------------------------
# the fidelity witness
# ---------------------------------------------------------------------------

def _witness_inputs(block, names: Sequence[str], device, batch: int = 8):
    """Deterministic concrete inputs per external chain input: numpy
    normals (scale 0.5) seeded by a stable hash of the var name, shaped
    from the recorded metadata with -1 dims resolved to ``batch``, as
    tensors of the var's type on ``device``. Drawn in float32 by numpy's
    default generator, not the JAX package's float64 ``RandomState``: at
    BERT-base's m = 16384 rows the draws are most of the witness's time,
    and this is 2.5x faster."""
    import zlib

    env = {}
    for name in names:
        v = block._var_recursive(name)
        shape = _static_shape(v, batch)
        if shape is None:
            raise ValueError(f"witness: '{name}' has no recorded shape")
        rng = np.random.default_rng(zlib.crc32(name.encode()))
        vals = rng.standard_normal(shape, dtype=np.float32)
        vals *= 0.5
        env[name] = torch.from_numpy(vals).to(device=device,
                                              dtype=torch_dtype(v.dtype))
    return env


def _witness_signature(block, chain: FusedChain) -> tuple:
    metas = []
    for slot in sorted(chain.inputs):
        v = block._var_recursive(chain.inputs[slot])
        metas.append((slot, _static_shape(v), str(v.dtype)))
    return (tuple(sorted((k, repr(v)) for k, v in chain.attrs.items())),
            tuple(metas))


def _chain_gemm_dims(block, chain: FusedChain,
                     batch: int = 8) -> Tuple[int, int, int]:
    """(m, n, k) of the chain's strictly-2-D GEMM view, with -1 dims
    resolved to ``batch`` (the executor plumbs the real feed rows; the
    small sentinel is only the direct-call default)."""
    xv = block._var_recursive(chain.inputs["X"])
    yv = block._var_recursive(chain.inputs["Y"])
    x_shape = _static_shape(xv, batch)
    xnc = chain.attrs["x_num_col_dims"] if chain.attrs["base_type"] == \
        "mul" else 1
    if chain.attrs["base_type"] == "matmul" and chain.attrs["transpose_X"]:
        x_shape = x_shape[::-1]
    y_shape = _static_shape(yv, batch)
    if chain.attrs["base_type"] == "matmul" and chain.attrs["transpose_Y"]:
        y_shape = y_shape[::-1]
    m = int(np.prod(x_shape[:xnc]))
    k = int(np.prod(x_shape[xnc:]))
    if chain.attrs["base_type"] == "mul":
        ync = chain.attrs["y_num_col_dims"]
        n = int(np.prod(y_shape[ync:]))
    else:
        n = int(y_shape[1])
    return m, n, k


def _device_fault(e: Optional[BaseException]) -> bool:
    """``e`` (or an exception it was raised from) says the kernel or the
    device failed, not the chain: a kernel that did not build, load or
    launch, or a CUDA error."""
    from ..kernels._build import KernelError

    while e is not None:
        if isinstance(e, KernelError) or "CUDA error" in str(e):
            return True
        e = e.__cause__
    return False


def _run_witness(program: Program, fused_program: Program,
                 chain: FusedChain, fused_op, device, batch: int = 8,
                 gemm_blocks=None) -> Tuple[Optional[str], dict]:
    """Execute original chain vs fused op over seeded inputs through the
    real op rules on ``device``. Returns (None on success, else the
    failure reason; a record of the route and the largest difference).
    Any exception is a refusal reason except a device fault
    (:func:`_device_fault`), which raises: refusing would cache the
    unfused program and run every later forward without the kernel.
    ``gemm_blocks`` is the block triple the real run will use: the
    witness executes the configuration that actually runs, not the
    defaults."""
    from ..lowering import LowerCtx, lower_op
    from ..ops.fused_gemm import (compute_dtype, fused_gemm_route,
                                  resolve_gemm_blocks)

    gb = program.global_block
    m, n, k = _chain_gemm_dims(gb, chain, batch=batch)
    rec = {"ops": list(chain.op_indices), "epilogue": chain.epilogue,
           "m": m, "n": n, "k": k}
    try:
        with torch.no_grad():
            ext = sorted(set(chain.inputs.values()))
            base_env = _witness_inputs(gb, ext, device, batch=batch)
            env_a = dict(base_env)
            ctx_a = LowerCtx(device, program=program)
            for oi in chain.op_indices:
                lower_op(gb.ops[oi], env_a, ctx_a)
            want = env_a[chain.out_name]

            env_b = dict(base_env)
            ctx_b = LowerCtx(device, gemm_blocks=gemm_blocks,
                             program=fused_program)
            lower_op(fused_op, env_b, ctx_b)
            got = env_b[chain.out_name]
    except Exception as e:
        if _device_fault(e):
            raise
        return f"witness execution failed: {type(e).__name__}: {e}", rec

    if want.shape != got.shape or want.dtype != got.dtype:
        return (f"witness meta mismatch: unfused {want.dtype}"
                f"{tuple(want.shape)} vs fused {got.dtype}"
                f"{tuple(got.shape)}"), rec

    # the chain's compute type: under AMP a white-list base op multiplies
    # in the policy's type and promotes back to f32 at the epilogue
    # params, so the output's type would overstate the precision the
    # kernel is held to
    comp = compute_dtype(ctx_b, chain.attrs["base_type"], torch_dtype(
        gb._var_recursive(chain.inputs["X"]).dtype))
    try:
        # the same flag > ctx > default resolution ctx_b's lowering used
        route, route_reason = fused_gemm_route(
            m, n, k, layer_norm=bool(chain.attrs["layer_norm"]),
            blocks=resolve_gemm_blocks(ctx_b),
            alpha=float(chain.attrs.get("alpha", 1.0)), dtype=comp,
            on_cuda=torch.device(device).type == "cuda")
    except ValueError as e:       # use_fused_gemm=always on a bad tiling
        return str(e), rec
    wf, gf = want.float(), got.float()
    diff = (wf - gf).abs()
    # the route's reason stays on the record: a chain the kernel refuses
    # (a K or N off its 4-element rows) names the dimension here
    rec.update(route=route, reason=route_reason,
               max_abs_err=float(diff.max()) if diff.numel() else 0.0)
    if route == "primitive":
        if not torch.equal(wf, gf):
            return (f"dense-route witness must be bit-exact; max abs diff "
                    f"{rec['max_abs_err']:.3e} over "
                    f"{int((diff > 0).sum())} element(s)"), rec
        return None, rec
    rtol, atol = WITNESS_TOLERANCES.get(canonical_dtype(comp),
                                        WITNESS_TOLERANCES["float32"])
    if not torch.allclose(wf, gf, rtol=rtol, atol=atol):
        return (f"kernel-route witness outside declared tolerance "
                f"(rtol={rtol}, atol={atol}): max abs diff "
                f"{rec['max_abs_err']:.3e}"), rec
    return None, rec


# ---------------------------------------------------------------------------
# the transform
# ---------------------------------------------------------------------------

def fuse_epilogues(program: Program, feed_names: Sequence[str] = (),
                   fetch_names: Sequence[str] = (),
                   live: Optional[Dict[str, object]] = None,
                   diags: Optional[List[Diagnostic]] = None,
                   batch: int = 8, gemm_blocks=None, device=None
                   ) -> FusionDecision:
    """Match + rewrite + witness. Returns a refused decision (the original
    program untouched) on any gate failure — never a wrong program.
    ``batch`` resolves -1 dims for the witness and the PT755 tiling
    report (the executor plumbs the real feed rows); ``gemm_blocks`` is
    the block triple the run will use; ``device`` is where the witness
    runs (the executor's: on a CUDA device it checks the kernel itself;
    default the CPU)."""
    from ..framework import Operator

    diags = diags if diags is not None else []
    gb = program.global_block

    for oi, op in enumerate(gb.ops):
        role = op.attrs.get("__op_role__", OpRole.Forward)
        if role != OpRole.Forward:
            diags.append(Diagnostic(
                "PT753",
                f"op {oi} ('{op.type}') has role '{role}' — epilogue "
                f"fusion only proves forward-only rewrites",
                gb.idx, oi, op.type, _site(op)))
            return FusionDecision(False, program,
                                  "backward-carrying program")

    if live is None:
        from .liveness import block_liveness

        feeds = {v.name for v in gb.vars.values() if v.is_data}
        feeds.update(feed_names or ())
        live = block_liveness(gb, sorted(feeds),
                              [getattr(f, "name", f)
                               for f in (fetch_names or ())])

    refusals_before = len(diags)
    chains = find_fusable_chains(program, live, fetch_names, diags)
    n_refused = len(diags) - refusals_before
    if not chains:
        return FusionDecision(False, program, "no fusable chains",
                              n_refused=n_refused)

    # -- rewrite on a clone (fresh _serial: caches never alias) ----------
    p = program.clone()
    new_gb = p.global_block
    # the fused op replaces the LAST chain op, not the first: a residual
    # operand may be produced between the matmul and the add, and placing
    # the fused op at the matmul's slot would read it before its def
    by_last = {c.op_indices[-1]: c for c in chains}
    removed = {oi for c in chains for oi in c.op_indices}
    new_ops = []
    fused_ops = []   # (chain, new Operator)
    for oi, op in enumerate(new_gb.ops):
        if oi not in removed:
            new_ops.append(op)
            continue
        c = by_last.get(oi)
        if c is None:
            continue   # an interior chain member: dropped
        base = new_gb.ops[c.op_indices[0]]
        fop = Operator(new_gb, "fused_gemm_epilogue",
                       inputs={k: [v] for k, v in c.inputs.items()},
                       outputs={"Out": [c.out_name]},
                       attrs=dict(c.attrs))
        fop.attrs["__uid__"] = p._next_uid()
        fop.attrs["__op_role__"] = OpRole.Forward
        if base.attrs.get("op_callstack"):
            fop.attrs["op_callstack"] = base.attrs["op_callstack"]
        new_ops.append(fop)
        fused_ops.append((c, fop))
    new_gb.ops = new_ops
    # sweep vars only the fused-away chain touched: the intermediates
    # (single-consumer by proof) and dead layer_norm side outputs
    still_used = set()
    for op in new_gb.ops:
        still_used.update(n for n in op.input_arg_names if n != EMPTY)
        still_used.update(n for n in op.output_arg_names if n != EMPTY)
    for c in chains:
        inter = []
        for oi in c.op_indices:
            inter.extend(n for n in program.global_block.ops[oi]
                         .output_arg_names if n != EMPTY)
        for name in inter + c.dead_outputs:
            v = new_gb.vars.get(name)
            if (v is not None and name not in still_used
                    and not v.persistable and not v.is_data):
                del new_gb.vars[name]
    p._bump_version()
    for _, fop in fused_ops:
        fop.infer_shape()

    # -- fidelity witness (memoized per chain signature) -----------------
    device = torch.device(device) if device is not None \
        else torch.device("cpu")
    seen: Dict[tuple, Optional[str]] = {}
    witnessed: List[dict] = []
    for c, fop in fused_ops:
        sig = _witness_signature(program.global_block, c)
        if sig not in seen:
            seen[sig], rec = _run_witness(program, p, c, fop, device,
                                          batch=batch,
                                          gemm_blocks=gemm_blocks)
            witnessed.append(rec)
        fail = seen[sig]
        if fail is not None:
            base_idx = c.op_indices[0]
            base = program.global_block.ops[base_idx]
            diags.append(Diagnostic(
                "PT754",
                f"chain at op {base_idx} ({c.epilogue}): {fail}",
                gb.idx, base_idx, base.type, _site(base)))
            return FusionDecision(
                False, program,
                f"fidelity witness failed for chain at op {base_idx}: "
                f"{fail}", n_refused=n_refused + 1, witness=witnessed)

    from types import SimpleNamespace

    from ..ops.fused_gemm import kernel_support, resolve_gemm_blocks

    blocks = resolve_gemm_blocks(SimpleNamespace(gemm_blocks=gemm_blocks))
    for c, fop in fused_ops:
        base_idx = c.op_indices[0]
        base = program.global_block.ops[base_idx]
        diags.append(Diagnostic(
            "PT750",
            f"fused {len(c.op_indices)}-op chain ({c.epilogue}) into "
            f"fused_gemm_epilogue writing '{c.out_name}'",
            gb.idx, base_idx, base.type, _site(base)))
        m, n, k = _chain_gemm_dims(gb, c, batch=batch)
        # the op lowering's own gate: alpha, type, then the tiling
        kind, reason = kernel_support(
            m, n, k, layer_norm=bool(c.attrs["layer_norm"]), blocks=blocks,
            alpha=float(c.attrs.get("alpha", 1.0)),
            dtype=gb._var_recursive(c.inputs["X"]).dtype)
        if kind != "supported":
            diags.append(Diagnostic(
                "PT755",
                f"chain at op {base_idx} (m={m}, n={n}, k={k}): {reason}",
                gb.idx, base_idx, base.type, _site(base)))

    return FusionDecision(
        True, p,
        f"fused {len(fused_ops)} chain(s)",
        n_fused=len(fused_ops), n_refused=n_refused,
        chains=[{"ops": list(c.op_indices), "epilogue": c.epilogue,
                 "out": c.out_name} for c, _ in fused_ops],
        witness=witnessed)


def epilogue_fusion_pass(program, ctx) -> FusionDecision:
    """The registered transform entry (builtin_passes): consumes the cached
    liveness analysis; reports PT750–PT756 on the context; the manager
    swaps in ``decision.program`` when applied. Options: ``gemm_blocks``
    and ``device`` (where the witness runs)."""
    live_info = ctx.analysis("liveness")
    diags: List[Diagnostic] = []
    decision = fuse_epilogues(program,
                              feed_names=list(ctx.feed_names),
                              fetch_names=list(ctx.fetch_names),
                              live=live_info["live"], diags=diags,
                              batch=int(ctx.batch_size or 8),
                              gemm_blocks=ctx.options.get("gemm_blocks"),
                              device=ctx.options.get("device"))
    for d in diags:
        ctx.report(d)
    return decision
