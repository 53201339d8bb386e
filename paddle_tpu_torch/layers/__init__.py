"""fluid.layers of the PyTorch port: the functions the port's model
builders call."""
from .io import data  # noqa: F401
from .nn import *  # noqa: F401,F403
from .nn2 import *  # noqa: F401,F403
from .tensor import *  # noqa: F401,F403
