"""paddle_tpu_torch.serving.fleet — the network serving tier above the
engine (counterpart of ``paddle_tpu/serving/fleet``, with its wire schema,
routes, routing policy and events).

* :mod:`~paddle_tpu_torch.serving.fleet.frontend` — a stdlib HTTP/JSON
  server per replica: ``/v1/submit``, ``/v1/generate`` (chunked token
  streaming), ``/healthz`` (the frozen engine health schema),
  ``/readyz`` and ``/metrics``, speaking the versioned wire schema of
  :mod:`~paddle_tpu_torch.serving.fleet.wire` (typed outcome -> distinct
  HTTP status, trace-ID headers, priority/SLO classes, deadlines).
* :mod:`~paddle_tpu_torch.serving.fleet.router` — load-aware dispatch over
  N replicas from each replica's pressure snapshot, honoring per-replica
  drain, retrying *unadmitted* requests exactly once on a sibling, and
  extending the exactly-one-outcome invariant fleet-wide.
* :mod:`~paddle_tpu_torch.serving.fleet.supervisor`,
  :mod:`~paddle_tpu_torch.serving.fleet.autoscaler` and
  :mod:`~paddle_tpu_torch.serving.fleet.telemetry` — replica processes
  with crash-loop classification and restart, the scale-out/scale-in
  control loop, and the cross-replica metrics aggregation (exact
  histogram merge).
* warm start — replicas run with ``FLAGS_aot_cache_dir``
  (:mod:`paddle_tpu_torch.aot_cache`): a cold replica loads its prepared
  executor steps instead of preparing them again.

``python -m paddle_tpu_torch.serving.fleet.replica`` runs one replica
process (model probe + warm-up + front-end + SIGTERM drain) on
``CUDAPlace(0)``, or on the CPU with ``--device cpu``.
"""
from __future__ import annotations

from .autoscaler import AutoscalerConfig, FleetAutoscaler
from .frontend import FrontendConfig, ServingFrontend
from .router import FleetRouter, Replica, RouterConfig
from .supervisor import (ReplicaCrashLoop, ReplicaSupervisor,
                         SupervisedReplica, SupervisorConfig)
from .telemetry import (METRICS_SCHEMA_VERSION, AggregatorConfig,
                        FleetAggregator, metrics_json)
from .wire import (SLO_CLASSES, TRACE_HEADER, WIRE_SCHEMA_VERSION,
                   ReplicaLost, WireError)

__all__ = [
    "ServingFrontend", "FrontendConfig", "FleetRouter", "Replica",
    "RouterConfig", "ReplicaSupervisor", "SupervisorConfig",
    "SupervisedReplica", "ReplicaCrashLoop", "ReplicaLost", "WireError",
    "WIRE_SCHEMA_VERSION", "TRACE_HEADER", "SLO_CLASSES",
    "FleetAggregator", "AggregatorConfig", "metrics_json",
    "METRICS_SCHEMA_VERSION", "FleetAutoscaler", "AutoscalerConfig",
]
