"""Weight-decay regularizers (counterpart of ``paddle_tpu/regularizer.py``;
reference python/paddle/fluid/regularizer.py: L2DecayRegularizer :112,
L1DecayRegularizer :184). Each appends ops that add its decay term to a
parameter's gradient before the optimizer's update op; a parameter's own
``ParamAttr.regularizer`` takes precedence over the optimizer's."""
from __future__ import annotations

from .layer_helper import LayerHelper

__all__ = ["L1Decay", "L2Decay", "L1DecayRegularizer", "L2DecayRegularizer",
           "append_regularization_ops"]


class WeightDecayRegularizer:
    def _append_regularization_op(self, param, grad, block):
        raise NotImplementedError


class L2DecayRegularizer(WeightDecayRegularizer):
    """grad + coeff * param."""

    def __init__(self, regularization_coeff=0.0):
        self._coeff = regularization_coeff

    def _append_regularization_op(self, param, grad, block):
        helper = LayerHelper("l2_decay")
        decay = helper.create_variable_for_type_inference(param.dtype, True)
        block.append_op("scale", inputs={"X": param}, outputs={"Out": decay},
                        attrs={"scale": self._coeff})
        out = helper.create_variable_for_type_inference(grad.dtype, True)
        block.append_op("sum", inputs={"X": [grad, decay]},
                        outputs={"Out": out})
        return out


class L1DecayRegularizer(WeightDecayRegularizer):
    """grad + coeff * sign(param), the sign as param / (|param| + 1e-12)."""

    def __init__(self, regularization_coeff=0.0):
        self._coeff = regularization_coeff

    def _append_regularization_op(self, param, grad, block):
        helper = LayerHelper("l1_decay")
        sign = helper.create_variable_for_type_inference(param.dtype, True)
        absx = helper.create_variable_for_type_inference(param.dtype, True)
        block.append_op("abs", inputs={"X": param}, outputs={"Out": absx})
        shifted = helper.create_variable_for_type_inference(param.dtype, True)
        block.append_op("scale", inputs={"X": absx}, outputs={"Out": shifted},
                        attrs={"scale": 1.0, "bias": 1e-12})
        block.append_op("elementwise_div", inputs={"X": param, "Y": shifted},
                        outputs={"Out": sign}, attrs={"axis": -1})
        decay = helper.create_variable_for_type_inference(param.dtype, True)
        block.append_op("scale", inputs={"X": sign}, outputs={"Out": decay},
                        attrs={"scale": self._coeff})
        out = helper.create_variable_for_type_inference(grad.dtype, True)
        block.append_op("sum", inputs={"X": [grad, decay]},
                        outputs={"Out": out})
        return out


L1Decay = L1DecayRegularizer
L2Decay = L2DecayRegularizer


def append_regularization_ops(params_grads, regularization=None):
    """(param, grad) pairs with each grad replaced by its regularized
    sum where the parameter or the optimizer has a regularizer."""
    out = []
    for p, g in params_grads:
        reg = getattr(p, "regularizer", None) or regularization
        if reg is None:
            out.append((p, g))
        else:
            out.append((p, reg._append_regularization_op(p, g, p.block)))
    return out
