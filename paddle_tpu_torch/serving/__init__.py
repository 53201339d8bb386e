"""paddle_tpu_torch.serving — inference serving with continuous batching,
admission control, deadlines and graceful degradation (counterpart of
``paddle_tpu/serving``). The contract: every submitted request reaches
exactly one terminal outcome — a response or a typed rejection — even
under overload and injected faults.

Quick start::

    from paddle_tpu_torch import serving

    infer = main.clone(for_test=True)          # params already in `scope`
    engine = serving.ServingEngine(infer, feed_names=["img", "label"],
                                   fetch_list=[logits], scope=scope,
                                   executor=exe)
    engine.warm_up()                           # run every bucket once
    with engine:                               # start()/stop(drain=True)
        fut = engine.submit({"img": x, "label": y}, deadline_s=0.5)
        logits_rows = fut.result()             # or typed ServingError

``GenerativeEngine`` serves a GPT model (prefill/decode slots, prefix
cache, chunked prefill, speculative decoding). The fleet tier
(``serving/fleet``) is not in the port yet.
"""
from ..resilience.deadline import Deadline, DeadlineExceeded
from .breaker import CircuitBreaker
from .engine import (HEALTH_SCHEMA_KEYS, HEALTH_SCHEMA_VERSION,
                     BatchFailed, CircuitOpen, EngineStopped, Overloaded,
                     PoisonRequest, ServingConfig, ServingEngine,
                     ServingError, ServingFuture)
from .generate import GenerationConfig, GenerativeEngine
from .prefix_cache import PrefixCache

__all__ = [
    "ServingEngine", "ServingConfig", "ServingFuture", "CircuitBreaker",
    "Deadline", "GenerativeEngine", "GenerationConfig", "PrefixCache",
    "ServingError", "Overloaded", "CircuitOpen", "BatchFailed",
    "PoisonRequest", "EngineStopped", "DeadlineExceeded",
    "HEALTH_SCHEMA_VERSION", "HEALTH_SCHEMA_KEYS",
]
