"""GEO-SGD transpiler compat surface (counterpart of
``paddle_tpu/transpiler/geo_sgd_transpiler.py``; reference
transpiler/geo_sgd_transpiler.py, communicator.h:320 GeoSgdCommunicator).
GEO-SGD shipped parameter deltas every k steps with no global barrier; the
class raises at construction with the JAX package's message, naming the
supported migration, LocalSGD.
"""
from __future__ import annotations

__all__ = ["GeoSgdTranspiler"]


class GeoSgdTranspiler:
    def __init__(self, config=None):
        raise NotImplementedError(
            "GEO-SGD is intentionally unsupported on TPU (async pserver "
            "consistency has no ICI analogue). Migrate to LocalSGD: "
            "fleet.DistributedStrategy(use_local_sgd=True) gives the same "
            "k-step communication cadence with defined averaging "
            "semantics.")
