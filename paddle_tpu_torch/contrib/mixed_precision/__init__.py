"""Mixed precision (AMP): counterpart of
``paddle_tpu/contrib/mixed_precision``."""
from .decorator import (OptimizerWithMixedPrecision, decorate,  # noqa: F401
                        decorate_program)
from .fp16_lists import AutoMixedPrecisionLists  # noqa: F401
