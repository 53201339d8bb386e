"""LayerHelper: shared machinery for layer functions (reference
layer_helper.py): creates parameters with initializer ops in the startup
program, temp output vars, and appends ops to the main program."""
from __future__ import annotations

from . import unique_name
from .framework import default_main_program, default_startup_program
from .initializer import Constant, Xavier
from .param_attr import ParamAttr


class LayerHelper:
    def __init__(self, layer_type: str, **kwargs):
        self.kwargs = kwargs
        self.layer_type = layer_type
        name = kwargs.get("name")
        self.name = name if name is not None \
            else unique_name.generate(layer_type)

    @property
    def main_program(self):
        return default_main_program()

    @property
    def startup_program(self):
        return default_startup_program()

    @property
    def block(self):
        return self.main_program.current_block()

    @property
    def param_attr(self) -> ParamAttr:
        return ParamAttr._to_attr(self.kwargs.get("param_attr"))

    @property
    def bias_attr(self):
        return ParamAttr._to_attr(self.kwargs.get("bias_attr"))

    def multiple_param_attr(self, length: int):
        pa = self.param_attr
        if isinstance(pa, ParamAttr):
            pa = [pa] * length
        return pa

    def create_parameter(self, attr, shape, dtype, is_bias: bool = False,
                         default_initializer=None):
        attr = attr if isinstance(attr, ParamAttr) \
            else ParamAttr._to_attr(attr)
        if attr is False:
            return None
        suffix = "b" if is_bias else "w"
        name = attr.name if attr.name else unique_name.generate(
            ".".join([self.name, suffix]))
        initializer = attr.initializer or default_initializer
        if initializer is None:
            initializer = Constant(0.0) if is_bias else Xavier()
        shape = [int(s) for s in shape]
        kwargs = attr._to_kwargs()
        kwargs.pop("name", None)
        param = self.main_program.global_block.create_parameter(
            name, shape, dtype, **kwargs)
        startup_blk = self.startup_program.global_block
        if not startup_blk.has_var(name):
            sp = startup_blk.create_parameter(name, shape, dtype, **kwargs)
            initializer(sp, startup_blk)
        return param

    def create_variable_for_type_inference(self, dtype, stop_gradient=False):
        return self.block.create_var(
            name=unique_name.generate(".".join([self.name, "tmp"])),
            dtype=dtype, stop_gradient=stop_gradient)

    # reference alias
    create_tmp_variable = create_variable_for_type_inference

    def create_global_variable(self, shape, dtype, persistable=False,
                               stop_gradient=True, name=None):
        return self.main_program.global_block.create_var(
            name=name or unique_name.generate(".".join([self.name,
                                                        "global"])),
            shape=shape, dtype=dtype, persistable=persistable,
            stop_gradient=stop_gradient)

    def append_op(self, type, inputs=None, outputs=None, attrs=None):
        return self.block.append_op(type, inputs=inputs, outputs=outputs,
                                    attrs=attrs)

    def append_bias_op(self, input_var, dim_start: int = 1, dim_end=None):
        bias_attr = self.bias_attr
        if bias_attr is False or bias_attr is None:
            return input_var
        size = list(input_var.shape[dim_start:dim_end])
        b = self.create_parameter(bias_attr, shape=size,
                                  dtype=input_var.dtype, is_bias=True)
        tmp = self.create_variable_for_type_inference(dtype=input_var.dtype)
        self.append_op("elementwise_add", inputs={"X": input_var, "Y": b},
                       outputs={"Out": tmp}, attrs={"axis": dim_start})
        return tmp

    def append_activation(self, input_var):
        act = self.kwargs.get("act")
        if act is None:
            return input_var
        if isinstance(act, str):
            act = {"type": act}
        act_type = act.pop("type")
        tmp = self.create_variable_for_type_inference(dtype=input_var.dtype)
        self.append_op(act_type, inputs={"X": input_var},
                       outputs={"Out": tmp}, attrs=act)
        return tmp
