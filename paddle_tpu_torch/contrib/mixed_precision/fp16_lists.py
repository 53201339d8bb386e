"""Op classification for mixed precision (counterpart of
``paddle_tpu/contrib/mixed_precision/fp16_lists.py``; reference
fp16_lists.py:24). White ops run in the low-precision compute type
(matrix products and convolutions: tensor cores), black ops are
numerically fragile and pinned to float32, every other (gray) op runs in
whatever type its inputs arrive. The sets name op types; an op the port
does not register yet is simply never met."""
from __future__ import annotations

__all__ = ["AutoMixedPrecisionLists", "WHITE_LIST", "BLACK_LIST"]

# tensor-core bound: the whole point of bf16
WHITE_LIST = {
    "mul", "matmul", "conv2d", "conv2d_transpose", "depthwise_conv2d",
}

# numerically fragile: exp/log/large reductions and normalisation statistics
BLACK_LIST = {
    "softmax", "softmax_with_cross_entropy", "cross_entropy", "log_softmax",
    "sigmoid_cross_entropy_with_logits", "mean", "layer_norm", "batch_norm",
    "group_norm", "instance_norm", "l2_normalize", "squared_l2_norm",
    "reduce_mean", "reduce_sum", "exp", "log", "pow", "softplus",
}


class AutoMixedPrecisionLists:
    """User-extendable white/black sets (reference fp16_lists.py:24). An
    op named in a custom list moves out of the other list; naming one op
    in both custom lists raises."""

    def __init__(self, custom_white_list=None, custom_black_list=None):
        self.white_list = set(WHITE_LIST)
        self.black_list = set(BLACK_LIST)
        if custom_white_list and custom_black_list:
            both = set(custom_white_list) & set(custom_black_list)
            if both:
                raise ValueError(f"ops in both custom lists: {sorted(both)}")
        for op in custom_white_list or ():
            self.black_list.discard(op)
            self.white_list.add(op)
        for op in custom_black_list or ():
            self.white_list.discard(op)
            self.black_list.add(op)
