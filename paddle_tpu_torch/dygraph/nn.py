"""Dygraph layer zoo (counterpart of ``paddle_tpu/dygraph/nn.py``;
reference dygraph/nn.py:35-2762: Conv2D, FC,
BatchNorm, Embedding, LayerNorm, ...). Thin parameterized wrappers over the
eager op namespace; all math lives in the shared op registry."""
from __future__ import annotations

import numpy as np

from . import ops
from .layers import Layer

__all__ = ["FC", "Linear", "Conv2D", "BatchNorm", "Embedding", "LayerNorm",
           "Pool2D", "Dropout", "GRUUnit", "NCE", "PRelu",
           "BilinearTensorProduct", "Conv2DTranspose", "GroupNorm",
           "SpectralNorm", "TreeConv", "RowConv", "SequenceConv"]


class FC(Layer):
    """reference dygraph/nn.py FC (input_dim explicit, as the later Linear)."""

    def __init__(self, input_dim, size, act=None, dtype="float32",
                 name_scope=None):
        super().__init__(name_scope or "fc", dtype)
        self.weight = self.create_parameter([int(input_dim), int(size)])
        self.bias = self.create_parameter([int(size)], is_bias=True)
        self._act = act

    def forward(self, x):
        out = ops.elementwise_add(ops.mul(x, self.weight), self.bias)
        return getattr(ops, self._act)(out) if self._act else out


Linear = FC


class Conv2D(Layer):
    def __init__(self, num_channels, num_filters, filter_size, stride=1,
                 padding=0, groups=1, act=None, use_bias=True,
                 dtype="float32", name_scope=None):
        super().__init__(name_scope or "conv2d", dtype)
        k = filter_size if isinstance(filter_size, (list, tuple)) \
            else (filter_size, filter_size)
        fan_in = num_channels * k[0] * k[1]
        fan_out = num_filters * k[0] * k[1]
        limit = float(np.sqrt(6.0 / (fan_in + fan_out)))
        from .layers import _param_rng

        w = _param_rng().uniform(
            -limit, limit,
            (num_filters, num_channels // groups, k[0], k[1])
        ).astype(dtype)
        self.weight = self.create_parameter(w.shape, dtype, init=w)
        self.bias = self.create_parameter([num_filters], is_bias=True) \
            if use_bias else None
        self._attrs = {"strides": [stride] * 2 if np.isscalar(stride)
                       else list(stride),
                       "paddings": [padding] * 2 if np.isscalar(padding)
                       else list(padding),
                       "groups": groups}
        self._act = act

    def forward(self, x):
        out = ops.conv2d(x, self.weight, None, **self._attrs)
        if self.bias is not None:
            out = ops.elementwise_add(out, self.bias, axis=1)
        return getattr(ops, self._act)(out) if self._act else out


class BatchNorm(Layer):
    """Eager batch_norm: running stats are parameters updated in place from
    the op's MeanOut/VarianceOut outputs (the reference aliases them)."""

    def __init__(self, num_channels, act=None, momentum=0.9, epsilon=1e-5,
                 dtype="float32", name_scope=None):
        super().__init__(name_scope or "batch_norm", dtype)
        self.weight = self.create_parameter([num_channels], init=1.0)
        self.bias = self.create_parameter([num_channels], is_bias=True)
        self._mean = self.create_parameter([num_channels], init=0.0,
                                           stop_gradient=True)
        self._variance = self.create_parameter([num_channels], init=1.0,
                                               stop_gradient=True)
        self._momentum = momentum
        self._epsilon = epsilon
        self._act = act

    def forward(self, x):
        y, mean_out, var_out, _, _ = ops.batch_norm(
            x, self.weight, self.bias, self._mean, self._variance,
            momentum=self._momentum, epsilon=self._epsilon,
            is_test=not self.training)
        if self.training:
            self._mean.set_value(mean_out.value)
            self._variance.set_value(var_out.value)
        return getattr(ops, self._act)(y) if self._act else y


class Embedding(Layer):
    def __init__(self, size, is_sparse=False, padding_idx=None,
                 dtype="float32", name_scope=None):
        super().__init__(name_scope or "embedding", dtype)
        self.weight = self.create_parameter(list(size))
        self._padding_idx = -1 if padding_idx is None else padding_idx

    def forward(self, ids):
        return ops.lookup_table(self.weight, ids,
                                padding_idx=self._padding_idx)


class LayerNorm(Layer):
    def __init__(self, normalized_shape, scale=True, shift=True,
                 epsilon=1e-5, act=None, dtype="float32", name_scope=None):
        super().__init__(name_scope or "layer_norm", dtype)
        if np.isscalar(normalized_shape):
            normalized_shape = [normalized_shape]
        n = int(np.prod(normalized_shape))
        self.weight = self.create_parameter([n], init=1.0) if scale else None
        self.bias = self.create_parameter([n], is_bias=True) if shift else None
        self._epsilon = epsilon
        self._act = act

    def forward(self, x):
        y, _, _ = ops.layer_norm(x, self.weight, self.bias,
                                 epsilon=self._epsilon,
                                 begin_norm_axis=len(x.shape) - 1)
        return getattr(ops, self._act)(y) if self._act else y


class Pool2D(Layer):
    def __init__(self, pool_size=2, pool_type="max", pool_stride=2,
                 pool_padding=0, global_pooling=False, name_scope=None):
        super().__init__(name_scope or "pool2d")
        self._attrs = {
            "pooling_type": pool_type,
            "ksize": [pool_size] * 2 if np.isscalar(pool_size)
            else list(pool_size),
            "strides": [pool_stride] * 2 if np.isscalar(pool_stride)
            else list(pool_stride),
            "paddings": [pool_padding] * 2 if np.isscalar(pool_padding)
            else list(pool_padding),
            "global_pooling": global_pooling,
        }

    def forward(self, x):
        return ops.pool2d(x, **self._attrs)


class Dropout(Layer):
    def __init__(self, p=0.5, name_scope=None):
        super().__init__(name_scope or "dropout")
        self._p = p

    def forward(self, x):
        r = ops.dropout(x, dropout_prob=self._p, is_test=not self.training)
        return r[0] if isinstance(r, tuple) else r  # drop the Mask output


class GRUUnit(Layer):
    """One GRU step (reference dygraph/nn.py:1509): gate input [B, 3H] is
    pre-projected; returns (gate, reset_hidden_prev, hidden)."""

    def __init__(self, size, activation="tanh", gate_activation="sigmoid",
                 origin_mode=False, dtype="float32", name_scope=None):
        super().__init__(name_scope or "gru_unit", dtype)
        h = size // 3
        self.weight = self.create_parameter([h, 3 * h])
        self.bias = self.create_parameter([1, 3 * h], is_bias=True)
        self._attrs = {"activation": activation,
                       "gate_activation": gate_activation,
                       "origin_mode": origin_mode}

    def forward(self, input, hidden_prev):
        return ops.gru_unit(input, hidden_prev, self.weight, self.bias,
                            **self._attrs)


class NCE(Layer):
    """Noise-contrastive estimation head (reference dygraph/nn.py:1684)."""

    def __init__(self, num_total_classes, dim, num_neg_samples=10,
                 sampler="uniform", seed=0, dtype="float32",
                 name_scope=None):
        super().__init__(name_scope or "nce", dtype)
        self.weight = self.create_parameter([num_total_classes, dim])
        self.bias = self.create_parameter([num_total_classes], is_bias=True)
        self._attrs = {
            "num_total_classes": int(num_total_classes),
            "num_neg_samples": int(num_neg_samples),
            "sampler": {"uniform": 0, "log_uniform": 1}[sampler],
            "seed": seed}

    def forward(self, input, label, sample_weight=None):
        cost, _, _ = ops.nce(input, label, self.weight, self.bias,
                             sample_weight, **self._attrs)
        return cost


class PRelu(Layer):
    """reference dygraph/nn.py PRelu: mode all/channel/element."""

    def __init__(self, mode="all", channel=None, input_shape=None,
                 dtype="float32", name_scope=None):
        super().__init__(name_scope or "prelu", dtype)
        if mode == "all":
            shape = [1]
        elif mode == "channel":
            shape = [int(channel)]
        elif mode == "element":
            shape = [int(np.prod(input_shape))]
        else:
            raise ValueError(f"prelu mode {mode!r}")
        self.weight = self.create_parameter(shape, init=0.25)
        self._mode = mode

    def forward(self, x):
        return ops.prelu(x, self.weight, mode=self._mode)


class BilinearTensorProduct(Layer):
    """out_k = x W_k y^T + b (reference dygraph/nn.py
    BilinearTensorProduct)."""

    def __init__(self, input1_dim, input2_dim, output_dim, dtype="float32",
                 name_scope=None):
        super().__init__(name_scope or "bilinear_tensor_product", dtype)
        self.weight = self.create_parameter(
            [output_dim, input1_dim, input2_dim])
        self.bias = self.create_parameter([1, output_dim], is_bias=True)

    def forward(self, x, y):
        return ops.bilinear_tensor_product(x, y, self.weight, self.bias)


class Conv2DTranspose(Layer):
    """reference dygraph/nn.py:2135."""

    def __init__(self, num_channels, num_filters, filter_size, stride=1,
                 padding=0, groups=1, act=None, use_bias=True,
                 dtype="float32", name_scope=None):
        super().__init__(name_scope or "conv2d_transpose", dtype)
        k = filter_size if isinstance(filter_size, (list, tuple)) \
            else (filter_size, filter_size)
        self.weight = self.create_parameter(
            [num_channels, num_filters // groups, k[0], k[1]])
        self.bias = self.create_parameter([num_filters], is_bias=True) \
            if use_bias else None
        self._attrs = {"strides": [stride] * 2 if np.isscalar(stride)
                       else list(stride),
                       "paddings": [padding] * 2 if np.isscalar(padding)
                       else list(padding),
                       "groups": groups}
        self._act = act

    def forward(self, x):
        out = ops.conv2d_transpose(x, self.weight, **self._attrs)
        if self.bias is not None:
            out = ops.elementwise_add(out, self.bias, axis=1)
        return getattr(ops, self._act)(out) if self._act else out


class GroupNorm(Layer):
    """reference dygraph/nn.py:2563."""

    def __init__(self, channels, groups, epsilon=1e-5, act=None,
                 dtype="float32", name_scope=None):
        super().__init__(name_scope or "group_norm", dtype)
        self.weight = self.create_parameter([channels], init=1.0)
        self.bias = self.create_parameter([channels], is_bias=True)
        self._attrs = {"groups": int(groups), "epsilon": epsilon}
        self._act = act

    def forward(self, x):
        y, _, _ = ops.group_norm(x, self.weight, self.bias, **self._attrs)
        return getattr(ops, self._act)(y) if self._act else y


class SpectralNorm(Layer):
    """reference dygraph/nn.py:2662: weight / sigma_max via power
    iteration. The U/V buffers persist on the layer; since the op is pure
    (see ops/misc.py spectral_norm), each call runs ``power_iters``
    iterations from the stored buffers."""

    def __init__(self, weight_shape, dim=0, power_iters=1, eps=1e-12,
                 dtype="float32", name_scope=None):
        super().__init__(name_scope or "spectral_norm", dtype)
        h = int(weight_shape[dim])
        w = int(np.prod(weight_shape)) // h
        from .layers import _param_rng

        self._u = self.create_parameter(
            [h], init=_param_rng().randn(h).astype(dtype),
            stop_gradient=True)
        self._v = self.create_parameter(
            [w], init=_param_rng().randn(w).astype(dtype),
            stop_gradient=True)
        self._attrs = {"dim": int(dim), "power_iters": int(power_iters),
                       "eps": eps}

    def forward(self, weight):
        return ops.spectral_norm(weight, self._u, self._v, **self._attrs)


class TreeConv(Layer):
    """reference dygraph/nn.py:2762: tree-based convolution (TBCNN)."""

    def __init__(self, feature_size, output_size, num_filters=1, max_depth=2,
                 act="tanh", use_bias=False, dtype="float32",
                 name_scope=None):
        super().__init__(name_scope or "tree_conv", dtype)
        self.weight = self.create_parameter(
            [feature_size, 3, output_size, num_filters])
        self.bias = self.create_parameter([1, 1, output_size, num_filters],
                                          is_bias=True) if use_bias else None
        self._attrs = {"max_depth": int(max_depth)}
        self._act = act

    def forward(self, nodes_vector, edge_set):
        out = ops.tree_conv(nodes_vector, edge_set, self.weight,
                            **self._attrs)
        if self.bias is not None:
            out = ops.elementwise_add(out, self.bias)
        return getattr(ops, self._act)(out) if self._act else out


class RowConv(Layer):
    """Lookahead row convolution (reference dygraph/nn.py RowConv)."""

    def __init__(self, future_context_size, dim, act=None, dtype="float32",
                 name_scope=None):
        super().__init__(name_scope or "row_conv", dtype)
        self.weight = self.create_parameter(
            [future_context_size + 1, dim])
        self._act = act

    def forward(self, x):
        out = ops.row_conv(x, self.weight)
        return getattr(ops, self._act)(out) if self._act else out


class SequenceConv(Layer):
    """Context-window conv over padded sequences (reference dygraph/nn.py
    SequenceConv). The padded+lengths encoding needs explicit lengths."""

    def __init__(self, dim, num_filters, filter_size=3, filter_stride=1,
                 act=None, dtype="float32", name_scope=None):
        super().__init__(name_scope or "sequence_conv", dtype)
        self.weight = self.create_parameter(
            [filter_size * dim, num_filters])
        self._attrs = {"contextLength": int(filter_size),
                       "contextStart": -((filter_size - 1) // 2),
                       "contextStride": int(filter_stride)}
        self._act = act

    def forward(self, x, seq_len):
        out = ops.sequence_conv(x, self.weight, seq_len, **self._attrs)
        return getattr(ops, self._act)(out) if self._act else out
