"""Fault-tolerance helpers of the PyTorch port (counterpart of
``paddle_tpu/resilience``): crash-safe checkpoints (``checkpoint``: the
manifest with per-file sha256, PT600-PT604, atomic publish and the
recovery walk), deadlines, deterministic fault injection
(``FLAGS_fault_plan``), retry with backoff for transient sites, the
non-finite step policies (``nonfinite``: ``FLAGS_nan_inf_policy``), the
step watchdog (``FLAGS_step_timeout_s``), graceful preemption
(``graceful``: SIGTERM -> one shutdown event that the training loop, the
serving engine's drain-stop and retry backoffs consume) and ``elastic``
(device-loss classification into a typed ``DeviceLostError``, rescale
planning with PT610-PT614, the ``DataCursor`` that ``contrib.Trainer``
checkpoints), with the data-parallel half of ``distributed.py``: sharded
checkpoints (format 2, PT605-PT609) and the cross-replica divergence
check. Not in the port yet: re-forming the process group on another rank
count (ROADMAP Queue A item 6, slice 28)."""
from .checkpoint import (CKPT_CODES, FORMAT_VERSION, CheckpointCorruptError,
                         atomic_replace_dir, finalize_manifest,
                         iter_serials, load_latest_checkpoint,
                         verify_checkpoint, verify_sharding_section)
from .deadline import Deadline, DeadlineExceeded
from .distributed import (ReplicaDivergenceError, WatchdogTimeout,
                          handle_divergence, replica_divergence_check,
                          set_divergence_recovery, watchdog_section)
from .elastic import (ELASTIC_CODES, DataCursor, DeviceLostError,
                      ElasticRescaleError, classify_device_error,
                      grad_accum_steps, plan_rescale, survivor_devices)
from .faults import (SITES, FaultPlan, InjectedFault, active_plan,
                     clear_plan, fault_action, fault_plan_guard,
                     fault_point, install_plan, stall)
from .graceful import (install_signal_handlers, on_shutdown,
                       request_shutdown, shutdown_event, shutdown_requested,
                       uninstall_signal_handlers)
from .nonfinite import POLICIES
from .retry import (RetryExhaustedError, RetryPolicy, call_with_retry,
                    is_transient, policy_for, retrying,
                    set_thread_stop_event)

__all__ = [
    # checkpoint integrity
    "CheckpointCorruptError", "CKPT_CODES", "FORMAT_VERSION",
    "verify_checkpoint", "verify_sharding_section", "finalize_manifest",
    "atomic_replace_dir", "iter_serials", "load_latest_checkpoint",
    # distributed resilience (sharded ckpts, divergence, watchdog)
    "ReplicaDivergenceError", "WatchdogTimeout", "watchdog_section",
    "replica_divergence_check", "handle_divergence",
    "set_divergence_recovery",
    # elastic preemption tolerance (device loss -> typed error; rescale
    # planning; the data cursor)
    "DeviceLostError", "ElasticRescaleError", "ELASTIC_CODES",
    "classify_device_error", "plan_rescale", "grad_accum_steps",
    "survivor_devices", "DataCursor",
    # fault injection
    "SITES", "FaultPlan", "InjectedFault", "active_plan", "clear_plan",
    "fault_action", "fault_plan_guard", "fault_point", "install_plan",
    "stall",
    # retry + deadlines
    "Deadline", "DeadlineExceeded", "RetryExhaustedError", "RetryPolicy",
    "call_with_retry", "is_transient", "policy_for", "retrying",
    "set_thread_stop_event",
    # graceful (SIGTERM/preemption-notice) shutdown
    "shutdown_event", "shutdown_requested", "request_shutdown",
    "on_shutdown", "install_signal_handlers", "uninstall_signal_handlers",
    # non-finite degradation
    "POLICIES",
]
