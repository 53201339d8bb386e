"""fluid.layers of the PyTorch port: the functions the port's model
builders call."""
from . import math_op_patch  # noqa: F401
from .io import data  # noqa: F401
from .nn import *  # noqa: F401,F403
from .nn2 import *  # noqa: F401,F403
from .tensor import (assign, create_global_var, create_tensor,  # noqa: F401
                     fill_constant, fill_constant_batch_size_like,
                     gaussian_random, linspace, ones, ones_like,
                     uniform_random, zeros, zeros_like)
from .control_flow import (While, Switch, IfElse, StaticRNN,  # noqa: F401
                           array_length, array_read, array_write, cond,
                           create_array, tensor_array_to_tensor)
from . import control_flow, nn, nn2, tensor  # noqa: F401
from .sequence import (sequence_pool, sequence_softmax,  # noqa: F401
                       sequence_reverse, sequence_expand, sequence_concat,
                       sequence_reshape, sequence_expand_as,
                       sequence_scatter, lod_reset, lod_append,
                       sequence_pad, sequence_unpad, sequence_slice,
                       sequence_erase, sequence_enumerate, sequence_conv,
                       sequence_first_step, sequence_last_step, sequence_mask)
from . import sequence  # noqa: F401
from .rnn import (DynamicRNN, dynamic_lstm, dynamic_lstmp,  # noqa: F401
                  dynamic_gru, gru_unit, lstm, warpctc)
from . import rnn  # noqa: F401
from . import detection, distributions  # noqa: F401
from .pipeline import PipelineRegion  # noqa: F401
from . import pipeline  # noqa: F401
from .learning_rate_scheduler import (cosine_decay, exponential_decay,  # noqa: F401
                                      inverse_time_decay, linear_lr_warmup,
                                      natural_exp_decay, noam_decay,
                                      piecewise_decay, polynomial_decay)
