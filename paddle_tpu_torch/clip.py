"""Gradient clipping (counterpart of ``paddle_tpu/clip.py``; reference
python/paddle/fluid/clip.py:137-233). The clip is process-global
(``set_gradient_clip``); ``Optimizer.apply_gradients`` appends its ops
before the regularization and update ops."""
from __future__ import annotations

from typing import List, Optional, Tuple

from .layer_helper import LayerHelper

__all__ = ["GradientClipByValue", "GradientClipByNorm",
           "GradientClipByGlobalNorm", "set_gradient_clip",
           "append_gradient_clip_ops", "error_clip_callback", "ErrorClipByValue"]

_clip_attr = {"__global__": None}


class BaseGradientClipAttr:
    def _append_clip_op(self, block, grad):
        raise NotImplementedError


class ErrorClipByValue:
    def __init__(self, max, min=None):
        self.max = max
        self.min = min if min is not None else -max


class GradientClipByValue(BaseGradientClipAttr):
    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -self.max

    def _append_clip_op(self, block, grad):
        helper = LayerHelper("clip_grad")
        out = helper.create_variable_for_type_inference(grad.dtype, True)
        block.append_op("clip", inputs={"X": grad}, outputs={"Out": out},
                        attrs={"min": self.min, "max": self.max})
        return out


class GradientClipByNorm(BaseGradientClipAttr):
    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def _append_clip_op(self, block, grad):
        helper = LayerHelper("clip_grad_norm")
        out = helper.create_variable_for_type_inference(grad.dtype, True)
        block.append_op("clip_by_norm", inputs={"X": grad},
                        outputs={"Out": out},
                        attrs={"max_norm": self.clip_norm})
        return out


class GradientClipByGlobalNorm(BaseGradientClipAttr):
    """g_i <- g_i * clip_norm / max(global_norm, clip_norm)."""

    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def _append_global_ops(self, block, params_grads):
        helper = LayerHelper("global_norm_clip")
        sq_norms = []
        for _, g in params_grads:
            sq = helper.create_variable_for_type_inference(g.dtype, True)
            block.append_op("squared_l2_norm", inputs={"X": g},
                            outputs={"Out": sq})
            sq_norms.append(sq)
        total = helper.create_variable_for_type_inference("float32", True)
        block.append_op("sum", inputs={"X": sq_norms}, outputs={"Out": total})
        gnorm = helper.create_variable_for_type_inference("float32", True)
        block.append_op("sqrt", inputs={"X": total}, outputs={"Out": gnorm})
        clipv = helper.create_variable_for_type_inference("float32", True)
        block.append_op("fill_constant", outputs={"Out": clipv},
                        attrs={"shape": [1], "dtype": "float32",
                               "value": self.clip_norm})
        denom = helper.create_variable_for_type_inference("float32", True)
        block.append_op("elementwise_max", inputs={"X": gnorm, "Y": clipv},
                        outputs={"Out": denom}, attrs={"axis": -1})
        scale = helper.create_variable_for_type_inference("float32", True)
        block.append_op("elementwise_div", inputs={"X": clipv, "Y": denom},
                        outputs={"Out": scale}, attrs={"axis": -1})
        outs = []
        for p, g in params_grads:
            out = helper.create_variable_for_type_inference(g.dtype, True)
            block.append_op("elementwise_mul", inputs={"X": g, "Y": scale},
                            outputs={"Out": out}, attrs={"axis": 0})
            outs.append((p, out))
        return outs


def set_gradient_clip(clip, param_list=None, program=None):
    _clip_attr["__global__"] = clip


def append_gradient_clip_ops(params_grads) -> List[Tuple]:
    clip = _clip_attr.get("__global__")
    if clip is None:
        return params_grads
    block = params_grads[0][0].block
    if isinstance(clip, GradientClipByGlobalNorm):
        return clip._append_global_ops(block, params_grads)
    return [(p, clip._append_clip_op(block, g)) for p, g in params_grads]


def error_clip_callback(block, context):
    pass
