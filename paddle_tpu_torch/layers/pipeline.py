"""layers.PipelineRegion: author a pipeline stage once, run it P times
(counterpart of ``paddle_tpu/layers/pipeline.py``).

Reference counterpart: PipelineOptimizer's cut-list sections placed on
devices and fed through scope queues (reference optimizer.py:2781,
trainer.h:110, device_worker.h:267). The user writes the repeated stage
ONCE as a sub-block; its parameters become [num_stages, ...]-stacked
persistable vars (named ``*.pp_stacked``, so the parallel step holds one
slice per 'pp' rank), and the ``pipeline`` op runs the GPipe microbatch
schedule over the mesh's 'pp' axis, or a loop over the stages when there
is no pipeline axis (ops/pipeline_op.py).

Usage::

    pipe = layers.PipelineRegion(num_stages=4, num_microbatches=8)
    with pipe.stage(x) as s:
        w = s.param("w", [d, d])
        b = s.param("b", [d], is_bias=True)
        h = layers.gelu(layers.elementwise_add(layers.matmul(s.input, w), b))
        s.set_output(h)
    y = pipe.output          # [B, ...] — x's shape

Stage bodies use explicit s.param(...) + math layers; layers that create
their own parameters (fc, conv2d) would create per-call params instead of
stacked ones and cannot be used inside the region.
"""
from __future__ import annotations

import contextlib

from .. import unique_name
from ..framework import Variable
from ..initializer import Constant, Xavier
from ..layer_helper import LayerHelper
from ..param_attr import ParamAttr

__all__ = ["PipelineRegion"]


class _StageHandle:
    def __init__(self, region):
        self._r = region

    @property
    def input(self) -> Variable:
        return self._r._in_var

    def param(self, name, shape, dtype="float32", initializer=None,
              is_bias=False):
        return self._r._make_param(name, shape, dtype, initializer, is_bias)

    def set_output(self, var: Variable):
        if tuple(var.shape) != tuple(self._r._in_var.shape):
            raise ValueError(
                f"pipeline stages must be shape-preserving (stage output "
                f"feeds the next stage's input): in {self._r._in_var.shape}"
                f" out {var.shape}")
        self._r._out_var = var


class PipelineRegion:
    def __init__(self, num_stages: int, num_microbatches: int = None,
                 name: str = None):
        self.num_stages = int(num_stages)
        self.num_microbatches = int(num_microbatches or num_stages)
        self._name = name or unique_name.generate("pipeline")
        self._stacked_names = []
        self._slice_names = []
        self._in_var = None
        self._out_var = None
        self.output = None

    @contextlib.contextmanager
    def stage(self, x: Variable):
        program = x.block.program
        parent = program.current_block()
        self._helper = LayerHelper(self._name)
        sub = program._create_block()
        self._sub = sub
        self._in_var = sub.create_var(
            name=unique_name.generate(f"{self._name}.in"),
            shape=x.shape, dtype=x.dtype, stop_gradient=False)
        try:
            yield _StageHandle(self)
        finally:
            program._rollback()
        if self._out_var is None:
            raise ValueError("pipeline stage never called set_output()")
        out = parent.create_var(
            name=unique_name.generate(f"{self._name}.out"),
            dtype=x.dtype, stop_gradient=False)
        parent.append_op(
            "pipeline",
            inputs={"X": [x.name], "StackedParams": list(self._stacked_names)},
            outputs={"Out": [out.name]},
            attrs={"sub_block": sub.idx,
                   "num_stages": self.num_stages,
                   "num_microbatches": self.num_microbatches,
                   "in_name": self._in_var.name,
                   "out_name": self._out_var.name,
                   "param_slices": list(self._slice_names)})
        self.output = out

    def _make_param(self, name, shape, dtype, initializer, is_bias):
        if initializer is None:
            initializer = Constant(0.0) if is_bias else Xavier()
        pname = f"{self._name}.{name}.pp_stacked"
        # the stacked parameter lives in the PARENT program (global block);
        # fan-in/out initializers see the per-stage trailing dims, not the
        # leading stage count, because Xavier on [P, d_in, d_out] treats
        # dim0 as a batch of receptive fields — acceptable: variance shifts
        # by 1/sqrt(P) only for rank-1 stacks
        stacked = self._helper.create_parameter(
            ParamAttr(name=pname), shape=[self.num_stages] + list(shape),
            dtype=dtype, default_initializer=initializer)
        self._stacked_names.append(stacked.name)
        sl = self._sub.create_var(
            name=unique_name.generate(f"{pname}.slice"),
            shape=list(shape), dtype=dtype, stop_gradient=False)
        self._slice_names.append(sl.name)
        return sl
