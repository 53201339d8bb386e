"""Graceful non-finite step degradation (``FLAGS_nan_inf_policy``).

Counterpart of ``paddle_tpu/resilience/nonfinite.py``, with its names,
policies, counter, incident and messages. ``FLAGS_check_nan_inf`` puts one
finite flag per float op output into every step (``lowering.lower_op``);
the executor reads them once at step end. The policy ladder:

* ``raise`` (default): restore the scope bit-exactly to its pre-step
  values, then raise with op provenance — catching the error leaves a
  usable session.
* ``skip``: DROP the step — the scope is rolled back bit-exactly to its
  pre-step values and training continues. The port writes each
  persistable into the scope as soon as an op writes it and updates the
  KV caches in place, so while the check is on the executor holds the
  pre-step tensor of every persistable the step writes (ops return fresh
  tensors, so a reference is the image) and a clone of every one written
  in place. ``FLAGS_nan_inf_max_consecutive_skips`` consecutive trips
  escalate to ``raise``.
* ``zero_grad``: the same bit-exact rollback (for a stateless optimizer
  this IS the zero-gradient update), but it never escalates.

Each dropped step increments ``steps_skipped_nonfinite_total{path,policy}``
and records a ``nonfinite_step`` flight-recorder incident. The
consecutive-skip counter lives on the Executor (``_nonfinite_consec``), so
independent executors escalate independently.
"""
from __future__ import annotations

import logging

__all__ = ["policy", "rollback_active", "record_skip", "record_clean",
           "witness_attribution", "POLICIES"]

logger = logging.getLogger("paddle_tpu_torch.resilience")

POLICIES = ("raise", "skip", "zero_grad")


def witness_attribution() -> str:
    """First-offending-var attribution from the numerics witness, as a
    message suffix. The executor records the step's witness stats BEFORE
    the nan-check protocol runs, so when a skip or escalation fires here
    the witness already knows WHICH var went non-finite first in program
    order. Empty string when the witness is off or the last step was
    clean."""
    from ..monitor import numwitness

    offender = numwitness.first_offender()
    if offender is None:
        return ""
    return (f" [numerics witness: first non-finite var this step was "
            f"'{offender}']")


def policy() -> str:
    from ..flags import flag

    p = str(flag("nan_inf_policy")).strip().lower()
    if p not in POLICIES:
        raise ValueError(
            f"FLAGS_nan_inf_policy={p!r} — expected one of {POLICIES}")
    return p


def rollback_active() -> bool:
    """True when the executor must hold the pre-step state image:
    whenever the sanitizer is on. ``skip``/``zero_grad`` need the image to
    drop the step; ``raise`` needs it so the raise restores pre-step state
    instead of leaving nan-poisoned parameters in the scope."""
    from ..flags import flag

    if not flag("check_nan_inf"):
        return False
    policy()  # validate eagerly: a typo'd policy fails the step, not the trip
    return True


def record_skip(path: str, label: str, exe=None) -> None:
    """Account one dropped step AFTER the scope has been rolled back.
    Raises ``FloatingPointError`` when ``skip`` escalation trips — the
    scope is already restored, so even the escalation leaves a usable
    session."""
    from .. import monitor as _monitor
    from ..flags import flag

    from .. import trace as _trace

    pol = policy()
    attribution = witness_attribution()
    _trace.record_incident(
        "nonfinite_step",
        detail=f"path '{path}': non-finite value in {label} "
               f"(policy {pol}){attribution}")
    if _monitor.enabled():
        _monitor.counter(
            "steps_skipped_nonfinite_total",
            "steps dropped (state rolled back) by FLAGS_nan_inf_policy").\
            labels(path=path, policy=pol).inc()
    if pol == "skip" and exe is not None:
        exe._nonfinite_consec = getattr(exe, "_nonfinite_consec", 0) + 1
        limit = int(flag("nan_inf_max_consecutive_skips"))
        if limit and exe._nonfinite_consec >= limit:
            raise FloatingPointError(
                f"FLAGS_nan_inf_policy=skip escalated to raise: "
                f"{exe._nonfinite_consec} consecutive non-finite steps "
                f"(limit {limit}; last: non-finite value in "
                f"{label}).{attribution} Persistent non-finiteness is a "
                f"model/data bug, not transient noise — state was rolled "
                f"back to pre-step values.")
    logger.warning(
        "nan_inf_policy=%s: dropping step on path '%s' (non-finite value "
        "in %s)%s; state rolled back to pre-step values", pol, path, label,
        attribution)


def record_clean(exe) -> None:
    """A finite step resets the consecutive-skip escalation counter."""
    if exe is not None:
        exe._nonfinite_consec = 0
