"""Quantization-aware training as a Program transform (counterpart of
``paddle_tpu/contrib/slim/quantization/quantization_pass.py``).

Reference: python/paddle/fluid/contrib/slim/quantization/
quantization_pass.py QuantizationTransformPass — walks the IrGraph and
inserts fake_quantize(+dequantize) ops on the inputs of quantizable ops
(conv2d, mul/matmul, depthwise_conv2d), abs_max for weights and
moving-average abs_max for activations.

Here the same rewrite happens on the Program: for every quantizable op, a
fake-quant op is spliced before each float input — weights (persistable
params) get in-graph abs_max, activations get a moving-average scale held
in a new persistable state var. Must run BEFORE minimize() so the
backward differentiates through the straight-through estimators.

Pass-order contract with GEMM-epilogue fusion (docs/ANALYSIS.md
"Quantization and epilogue fusion"): QAT must ALSO run before
``analysis.epilogue_fusion`` — fusion consumes the fake-quant outputs as
GEMM inputs and the PT900 pairing check stays satisfiable; run the other
way round, the GEMM this pass wants to annotate has been swallowed into a
``fused_gemm_epilogue`` op it does not know how to split, and the quant
scaffolding would silently attach to nothing. ``apply`` refuses a
pre-fused program loudly instead of mis-pairing.
"""
from __future__ import annotations

from typing import Optional, Sequence

from ....framework import Operator, Program, default_startup_program
from .... import unique_name

_DEFAULT_QUANTIZABLE = ("conv2d", "depthwise_conv2d", "mul", "matmul")


class QuantizationTransformPass:
    def __init__(self, weight_bits: int = 8, activation_bits: int = 8,
                 moving_rate: float = 0.9,
                 quantizable_op_type: Sequence[str] = _DEFAULT_QUANTIZABLE,
                 skip_pattern: str = "skip_quant"):
        self.weight_bits = weight_bits
        self.activation_bits = activation_bits
        self.moving_rate = moving_rate
        self.quantizable = tuple(quantizable_op_type)
        self.skip_pattern = skip_pattern

    def apply(self, program: Program,
              startup_program: Optional[Program] = None) -> int:
        """Insert fake-quant ops; returns how many inputs were quantized."""
        startup = startup_program or default_startup_program()
        block = program.global_block
        fused = [i for i, op in enumerate(block.ops)
                 if op.type == "fused_gemm_epilogue"]
        if fused:
            raise ValueError(
                f"QuantizationTransformPass: program already contains "
                f"{len(fused)} fused_gemm_epilogue op(s) (first at global "
                f"block index {fused[0]}) — quantization must run BEFORE "
                f"epilogue fusion, not after: the GEMMs this pass would "
                f"annotate are gone and the fake-quant/GEMM pairing the "
                f"PT900 check enforces could not be established. Apply "
                f"quant_aware() to the unfused program, then fuse "
                f"(docs/ANALYSIS.md, 'Quantization and epilogue fusion').")
        quantized_of = {}  # source var -> fake-quant output name
        n = 0
        new_ops = []
        for op in block.ops:
            if op.type in self.quantizable and \
                    self.skip_pattern not in str(
                        op.attrs.get("op_namescope", "")):
                for slot, names in op.inputs.items():
                    new_names = []
                    for name in names:
                        v = block.vars.get(name)
                        if v is None or not _is_float(v.dtype):
                            new_names.append(name)
                            continue
                        if name not in quantized_of:
                            qname, qops = self._make_quant(
                                block, startup, name,
                                is_weight=getattr(v, "persistable", False))
                            new_ops.extend(qops)
                            quantized_of[name] = qname
                            n += 1
                        new_names.append(quantized_of[name])
                    op.inputs[slot] = new_names
            new_ops.append(op)
            # A name this op (re)defines invalidates any cached fake-quant
            # of it: a later consumer must quantize the NEW value, not the
            # stale one computed from the earlier definition.
            for names in op.outputs.values():
                for name in names:
                    quantized_of.pop(name, None)
        block.ops = new_ops
        program._bump_version()
        return n

    def _make_quant(self, block, startup, name, is_weight):
        v = block.vars[name]
        qname = unique_name.generate(name + ".quantized")
        block.create_var(name=qname, shape=v.shape, dtype=v.dtype,
                         stop_gradient=False)
        scale_name = unique_name.generate(name + ".quant_scale")
        block.create_var(name=scale_name, shape=(1,), dtype="float32",
                         stop_gradient=True, persistable=not is_weight)
        ops = []
        if is_weight:
            op = Operator(block, "fake_quantize_dequantize_abs_max",
                          inputs={"X": [name]},
                          outputs={"Out": [qname],
                                   "OutScale": [scale_name]},
                          attrs={"bit_length": self.weight_bits})
        else:
            # moving-average scale: persistable state initialised to 1
            startup_blk = startup.global_block
            if not startup_blk.has_var(scale_name):
                startup_blk.create_var(name=scale_name, shape=(1,),
                                       dtype="float32", persistable=True)
                startup_blk.append_op(
                    "fill_constant", outputs={"Out": scale_name},
                    attrs={"shape": [1], "dtype": "float32", "value": 1.0})
            op = Operator(
                block, "fake_quantize_dequantize_moving_average_abs_max",
                inputs={"X": [name], "InScale": [scale_name]},
                outputs={"Out": [qname], "OutScale": [scale_name]},
                attrs={"bit_length": self.activation_bits,
                       "moving_rate": self.moving_rate})
        block._stamp(op)
        ops.append(op)
        return qname, ops


def quant_aware(program: Program, startup_program: Optional[Program] = None,
                weight_bits: int = 8, activation_bits: int = 8,
                quantizable_op_type: Sequence[str] = _DEFAULT_QUANTIZABLE):
    """The PaddleSlim-style one-call entry: rewrite ``program`` for QAT.
    Call BEFORE minimize()."""
    p = QuantizationTransformPass(weight_bits, activation_bits,
                                  quantizable_op_type=quantizable_op_type)
    p.apply(program, startup_program)
    return program


def _is_float(dtype) -> bool:
    return str(dtype).startswith("float") or str(dtype) == "bfloat16"
