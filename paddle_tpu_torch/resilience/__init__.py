"""Fault-tolerance helpers of the PyTorch port (counterpart of
``paddle_tpu/resilience``): deadlines, deterministic fault injection
(``FLAGS_fault_plan``), retry with backoff for transient sites, and the
step watchdog (``FLAGS_step_timeout_s``). Checkpointing, elastic
rescale, the non-finite policies and graceful preemption are not in the
port yet."""
from .deadline import Deadline, DeadlineExceeded
from .distributed import WatchdogTimeout, watchdog_section
from .faults import (SITES, FaultPlan, InjectedFault, active_plan,
                     clear_plan, fault_action, fault_plan_guard,
                     fault_point, install_plan, stall)
from .retry import (RetryExhaustedError, RetryPolicy, call_with_retry,
                    is_transient, policy_for)

__all__ = [
    "Deadline", "DeadlineExceeded", "WatchdogTimeout", "watchdog_section",
    "SITES", "FaultPlan", "InjectedFault", "active_plan", "clear_plan",
    "fault_action", "fault_plan_guard", "fault_point", "install_plan",
    "stall", "RetryExhaustedError", "RetryPolicy", "call_with_retry",
    "is_transient", "policy_for",
]
