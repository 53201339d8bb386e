"""fluid.layers of the PyTorch port: the functions the port's model
builders call."""
from .io import data  # noqa: F401
from .nn import *  # noqa: F401,F403
from .nn2 import *  # noqa: F401,F403
from .tensor import *  # noqa: F401,F403
from .learning_rate_scheduler import (cosine_decay, exponential_decay,  # noqa: F401
                                      inverse_time_decay, linear_lr_warmup,
                                      natural_exp_decay, noam_decay,
                                      piecewise_decay, polynomial_decay)
