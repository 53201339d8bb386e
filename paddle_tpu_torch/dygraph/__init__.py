"""Dygraph (eager) mode of the port (counterpart of
``paddle_tpu/dygraph``; reference paddle/fluid/imperative/ +
python/paddle/fluid/dygraph/). See base.py for the tape."""
from .base import (VarBase, guard, to_variable, enabled,  # noqa: F401
                   in_dygraph_mode, current_tape)
from .checkpoint import load_dygraph, save_dygraph  # noqa: F401
from .layers import Layer  # noqa: F401
from .layers import seed_parameters  # noqa: F401
from .nn import (FC, NCE, BatchNorm, BilinearTensorProduct,  # noqa: F401
                 Conv2D, Conv2DTranspose, Dropout, Embedding, GroupNorm,
                 GRUUnit, LayerNorm, Linear, Pool2D, PRelu, RowConv,
                 SequenceConv, SpectralNorm, TreeConv)
from . import nn  # noqa: F401
from . import ops  # noqa: F401
from .learning_rate_scheduler import (CosineDecay,  # noqa: F401
                                      ExponentialDecay, InverseTimeDecay,
                                      LearningRateDecay, NaturalExpDecay,
                                      NoamDecay, PiecewiseDecay,
                                      PolynomialDecay)
from . import learning_rate_scheduler  # noqa: F401
from .parallel import DataParallel, ParallelEnv, prepare_context  # noqa: F401
