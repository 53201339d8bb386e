from .quantization_pass import (QuantizationTransformPass,  # noqa: F401
                                quant_aware)
