"""Runtime numerics witness (counterpart of
``paddle_tpu/monitor/numwitness.py``, with its names and metrics).

With ``FLAGS_numerics_witness=1`` the executor's step appends one tap per
float op output (``lowering.lower_op``, next to the FLAGS_check_nan_inf
taps): an ``[abs-max, min, max, nonfinite-count]`` stats vector computed
on the device, stacked into one ``(N, 4)`` tensor at step end and read
with one device->host transfer — never a sync per op. The executor hands
each step's stats to :func:`record_step`, which merges them into a
process-wide per-var range store and mirrors them onto the monitor
registry when ``FLAGS_monitor`` is on.

:func:`containment_violations` is the cross-check against statically
proven per-var intervals (every observed finite value must lie inside
its var's interval, tolerance-free). It is pure logic over a dict; the
static side is ``analysis.numerics.static_intervals(program, fetch)``:
``containment_violations(static_intervals(program, fetch))`` after a
witnessed run.

The witness is also the attribution source for the nan/inf machinery:
:func:`first_offender` names the first var of the most recent step whose
nonfinite count is nonzero, which ``resilience.nonfinite`` folds into the
skip-escalation message and the ``nonfinite_step`` incident.

Disabled (the default) this module costs nothing on the hot path: the
executor passes no tap list and no tap ever runs.

Min/max fold nonfinite lanes away; the nonfinite population is carried
separately in the count lane, so a var that went inf still reports the
range of its finite values.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "numerics_witness_enabled", "record_step", "first_offender",
    "numerics_witness_vars", "numerics_witness_report",
    "reset_numerics_witness", "containment_violations",
]


def numerics_witness_enabled() -> bool:
    """``FLAGS_numerics_witness`` (default off)."""
    from ..flags import flag

    return bool(flag("numerics_witness"))


class _VarRange:
    __slots__ = ("absmax", "min", "max", "nonfinite", "steps")

    def __init__(self):
        self.absmax = 0.0
        self.min = np.inf       # stays +inf until a finite value is seen
        self.max = -np.inf
        self.nonfinite = 0
        self.steps = 0

    def to_dict(self) -> dict:
        return {"absmax": float(self.absmax),
                "min": None if not np.isfinite(self.min) else float(self.min),
                "max": None if not np.isfinite(self.max) else float(self.max),
                "nonfinite": int(self.nonfinite), "steps": int(self.steps)}


class _WitnessState:
    """Process-wide range store. Guarded by a plain lock; recording never
    runs device code — the stats arrive as one host array per step."""

    def __init__(self):
        self.lock = threading.Lock()
        self.vars: Dict[str, _VarRange] = {}
        self.last_offender: Optional[str] = None


_state = _WitnessState()


def record_step(names: Sequence[str], stats, path: str = "run") -> None:
    """Merge one step's ``(N, 4)`` stats array (rows aligned with
    ``names``: abs-max, min, max, nonfinite-count). Called by the executor
    after every witness-instrumented dispatch."""
    arr = np.asarray(stats, dtype=np.float64)
    if arr.size == 0:
        with _state.lock:
            _state.last_offender = None
        return
    offender = None
    with _state.lock:
        for name, row in zip(names, arr):
            r = _state.vars.get(name)
            if r is None:
                r = _state.vars[name] = _VarRange()
            r.absmax = max(r.absmax, float(row[0]))
            r.min = min(r.min, float(row[1]))
            r.max = max(r.max, float(row[2]))
            n_bad = int(row[3])
            r.nonfinite += n_bad
            r.steps += 1
            if n_bad and offender is None:
                offender = name
        _state.last_offender = offender
    _publish(names, arr, path)


def _publish(names: Sequence[str], arr, path: str) -> None:
    """Mirror into the monitor registry."""
    from . import counter, enabled, gauge

    if not enabled():
        return
    total_bad = int(arr[:, 3].sum())
    if total_bad:
        counter("numerics_nonfinite_values_total",
                "nonfinite elements observed by the numerics witness "
                "(FLAGS_numerics_witness), by path").labels(
            path=path).inc(total_bad)
    gauge("numerics_witness_vars",
          "vars instrumented by the numerics witness in the most recent "
          "step, by path").labels(path=path).set(len(names))
    # per-var gauges only for the step's worst offenders: full per-var
    # label cardinality belongs in numerics_witness_report()
    order = np.argsort(arr[:, 0])[::-1][:8]
    for i in order:
        gauge("numerics_var_absmax",
              "observed abs-max of the largest-magnitude witnessed vars "
              "(most recent step)").labels(var=str(names[int(i)])).set(
            float(arr[int(i), 0]))


def first_offender() -> Optional[str]:
    """First var of the most recent recorded step with a nonzero
    nonfinite count (None = last step was clean). The attribution the
    nan_inf_policy escalation and the flight recorder's nonfinite
    incident name."""
    with _state.lock:
        return _state.last_offender


def numerics_witness_vars() -> Dict[str, dict]:
    """Merged per-var observed ranges since the last reset."""
    with _state.lock:
        return {n: r.to_dict() for n, r in sorted(_state.vars.items())}


def numerics_witness_report() -> dict:
    """Everything observed since the last :func:`reset_numerics_witness`."""
    vars_ = numerics_witness_vars()
    return {
        "enabled": numerics_witness_enabled(),
        "vars": vars_,
        "nonfinite_total": sum(v["nonfinite"] for v in vars_.values()),
        "first_offender": first_offender(),
    }


def reset_numerics_witness() -> None:
    with _state.lock:
        _state.vars.clear()
        _state.last_offender = None


def containment_violations(
        static_intervals: Dict[str, Tuple[float, float]],
        observed: Optional[Dict[str, dict]] = None) -> List[dict]:
    """Every observed finite value must lie inside its statically-proven
    interval, tolerance-free (the static side is conservative by
    construction — an escape is an analysis soundness bug). Only vars
    present on BOTH sides are compared; each violation names the var,
    the bound and both values."""
    if observed is None:
        observed = numerics_witness_vars()
    violations = []
    for name, (lo, hi) in sorted(static_intervals.items()):
        obs = observed.get(name)
        if obs is None or obs["min"] is None:
            continue        # never witnessed, or no finite value seen
        if obs["min"] < lo:
            violations.append({
                "var": name, "bound": "lo", "static": lo,
                "observed": obs["min"],
                "detail": f"observed min {obs['min']:g} < static lower "
                          f"bound {lo:g}"})
        if obs["max"] > hi:
            violations.append({
                "var": name, "bound": "hi", "static": hi,
                "observed": obs["max"],
                "detail": f"observed max {obs['max']:g} > static upper "
                          f"bound {hi:g}"})
    return violations
