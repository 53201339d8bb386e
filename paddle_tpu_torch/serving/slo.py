"""Multi-window SLO burn-rate tracking per priority class (a copy of
``paddle_tpu/serving/slo.py``).

Every terminal request outcome is scored against a declared per-class latency
objective — a completed request slower than its class target, or ANY
non-completed terminal outcome, consumes error budget — and the burn
rate (observed bad fraction / allowed bad fraction) is tracked over two
windows, the classic fast+slow multi-window burn alert:

* **fast** (default 60 s): pages quickly when the budget is burning hard;
* **slow** (default 600 s): confirms the burn is sustained, so a single
  bad second never flips the state alone.

``state()`` reduces to ``ok`` (neither window burning), ``warning``
(exactly one window >= 1x budget) or ``burning`` (both) — the payload
rides ``ServingEngine.health()`` under the ``"slo"`` key. Objectives
come from ``ServingConfig`` (``FLAGS_serving_slo_*`` defaults). The
tracker takes an injectable clock.
"""
from __future__ import annotations

import collections
import threading
import time
from typing import Dict, Optional

__all__ = ["SloBurnTracker", "parse_latency_targets",
           "class_for_priority", "PRIORITY_CLASS_NAMES",
           "STATE_ORDER"]

# priority -> class name (batch=0 / standard=1 / interactive=2); priorities outside the declared
# classes clamp to the nearest one so an explicit priority=7 request is
# still tracked (as the strictest class) instead of invisible.
PRIORITY_CLASS_NAMES = ("batch", "standard", "interactive")
STATE_ORDER = ("ok", "warning", "burning")

_DEFAULT_TARGETS = "batch:30,standard:1.0,interactive:0.25"


def class_for_priority(priority: int) -> str:
    p = max(0, min(int(priority), len(PRIORITY_CLASS_NAMES) - 1))
    return PRIORITY_CLASS_NAMES[p]


def parse_latency_targets(spec: Optional[str]) -> Dict[str, float]:
    """Parse ``'class:seconds,...'`` into ``{class: target_s}``; unknown
    class names raise (a typo would silently stop tracking that class)."""
    spec = (spec or "").strip() or _DEFAULT_TARGETS
    out: Dict[str, float] = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        if ":" not in part:
            raise ValueError(
                f"bad SLO latency spec {part!r} (want 'class:seconds')")
        name, _, val = part.partition(":")
        name = name.strip()
        if name not in PRIORITY_CLASS_NAMES:
            raise ValueError(
                f"unknown SLO class {name!r} — "
                f"known: {PRIORITY_CLASS_NAMES}")
        out[name] = float(val)
        if out[name] <= 0:
            raise ValueError(f"SLO latency target must be > 0: {part!r}")
    return out


class _ClassWindow:
    """Per-class good/bad counts in 1-second buckets, bounded to the
    slow window."""

    __slots__ = ("buckets", "target_s")

    def __init__(self, target_s: float):
        self.target_s = target_s
        # deque of [second:int, good:int, bad:int], oldest first
        self.buckets = collections.deque()

    def observe(self, now_s: int, bad: bool, keep_s: float) -> None:
        if self.buckets and self.buckets[-1][0] == now_s:
            slot = self.buckets[-1]
        else:
            slot = [now_s, 0, 0]
            self.buckets.append(slot)
        slot[2 if bad else 1] += 1
        horizon = now_s - keep_s
        while self.buckets and self.buckets[0][0] < horizon:
            self.buckets.popleft()

    def totals(self, now_s: int, window_s: float):
        good = bad = 0
        horizon = now_s - window_s
        for sec, g, b in self.buckets:
            if sec > horizon:
                good += g
                bad += b
        return good, bad


class SloBurnTracker:
    """Thread-safe burn-rate tracker; one per engine.

    ``observe()`` is called from the engine's settle paths (terminal
    outcome known) — it is a few dict/int ops under the tracker's own
    lock, safe under the engine lock. ``state()`` serializes the whole
    tracker for the health payload and refreshes the ``slo_burn_*``
    registry gauges.
    """

    def __init__(self, targets: Dict[str, float],
                 error_budget: float = 0.01,
                 fast_window_s: float = 60.0,
                 slow_window_s: float = 600.0,
                 _now=time.monotonic):
        if error_budget <= 0 or error_budget > 1:
            raise ValueError(
                f"error budget must be in (0, 1]: {error_budget}")
        if fast_window_s <= 0 or slow_window_s < fast_window_s:
            raise ValueError(
                "windows must satisfy 0 < fast <= slow: "
                f"{fast_window_s} / {slow_window_s}")
        self.error_budget = float(error_budget)
        self.fast_window_s = float(fast_window_s)
        self.slow_window_s = float(slow_window_s)
        self._now = _now
        from .. import monitor

        self._lock = monitor.make_lock("SloBurnTracker._lock")
        self._classes = {name: _ClassWindow(t)
                         for name, t in sorted(targets.items())}

    def observe(self, priority: int, latency_s: Optional[float],
                error: bool) -> None:
        """Record one terminal outcome. ``error`` marks any
        non-completed outcome; a completed request is bad iff slower
        than its class latency target. Unknown classes (no declared
        objective) are not tracked."""
        cls = self._classes.get(class_for_priority(priority))
        if cls is None:
            return
        bad = bool(error) or (latency_s is not None
                              and latency_s > cls.target_s)
        now_s = int(self._now())
        with self._lock:
            cls.observe(now_s, bad, self.slow_window_s)

    def _burn(self, cls: _ClassWindow, now_s: int,
              window_s: float) -> Optional[float]:
        good, bad = cls.totals(now_s, window_s)
        total = good + bad
        if not total:
            return None
        return (bad / total) / self.error_budget

    def state(self) -> dict:
        """Serializable tracker state (the health payload's ``"slo"``
        value): per-class fast/slow burn rates and reduced states, plus
        the worst class state at the top. Refreshes the registry's
        ``slo_burn_rate{class,window}`` / ``slo_burn_state{class}``
        gauges as a side effect (the scrapeable mirror)."""
        from .. import monitor

        now_s = int(self._now())
        classes = {}
        worst = "ok"
        with self._lock:
            for name, cls in self._classes.items():
                fast = self._burn(cls, now_s, self.fast_window_s)
                slow = self._burn(cls, now_s, self.slow_window_s)
                hot = sum(1 for b in (fast, slow)
                          if b is not None and b >= 1.0)
                st = STATE_ORDER[hot]
                if STATE_ORDER.index(st) > STATE_ORDER.index(worst):
                    worst = st
                good, bad = cls.totals(now_s, self.slow_window_s)
                classes[name] = {
                    "target_s": cls.target_s,
                    "fast_burn": fast,
                    "slow_burn": slow,
                    "state": st,
                    "good": good,
                    "bad": bad,
                }
        if monitor.enabled():
            for name, c in classes.items():
                monitor.gauge(
                    "slo_burn_rate",
                    "SLO burn rate (bad fraction / error budget) per "
                    "priority class and window").labels(
                        **{"class": name, "window": "fast"}).set(
                            c["fast_burn"] or 0.0)
                monitor.gauge("slo_burn_rate").labels(
                    **{"class": name, "window": "slow"}).set(
                        c["slow_burn"] or 0.0)
                monitor.gauge(
                    "slo_burn_state",
                    "reduced SLO state per class: 0=ok 1=warning "
                    "2=burning").labels(**{"class": name}).set(
                        STATE_ORDER.index(c["state"]))
        return {
            "state": worst,
            "error_budget": self.error_budget,
            "fast_window_s": self.fast_window_s,
            "slow_window_s": self.slow_window_s,
            "classes": classes,
        }
