"""Deterministic fault injection (``FLAGS_fault_plan``), a copy of
``paddle_tpu/resilience/faults.py``: the same plan grammar, site names,
actions and seeded replay.

Sites the port probes (via :func:`fault_point`):

=================  ==========================================================
site               probed where
=================  ==========================================================
``compile``        ``Executor``, at the compile event of a new key (the
                   first run of a program/feed/fetch key), retried as a
                   transient site
``device_put``     each feed's host->device copy (``Executor``), retried as
                   a transient site
``step``           immediately before a program runs (run / run_chained)
``hang``           inside the watchdog-armed section of run / run_chained
                   — pair with the ``hang`` action to stall a step the
                   watchdog must break
``enqueue``        ``serving.ServingEngine.submit`` before admission
                   control — a typed submission failure the caller sees
``batch_dispatch`` in the serving dispatch thread immediately before a
                   batch (or a generative prefill/decode/verify dispatch)
                   executes — fails that batch's requests typed and feeds
                   the circuit breaker
``overload``       inside serving admission control — forces an
                   ``Overloaded`` rejection exactly as if the queue were full
=================  ==========================================================

The other names in :data:`SITES` (checkpoint, device-loss and fleet-wire
sites) are accepted in a plan, as in the reference, and never fire here:
nothing in the port probes them yet.

Plan grammar (``FLAGS_fault_plan``, comma-separated rules)::

    site:N:action     fire on the first N hits of the site
    site:@K:action    fire exactly on the K-th hit (1-based)
    site:pX:action    fire with probability X per hit (seeded by
                      FLAGS_fault_seed — the same plan replays identically)

Actions: an exception class name (``RuntimeError``, ``OSError``,
``TimeoutError``, ``ConnectionError`` — raised as an *injected* subclass so
handlers can tell injected faults from real ones), ``kill`` —
``os._exit(137)``, a mid-write SIGKILL stand-in that skips every ``finally``
block exactly like the real signal — or ``hang``: an interruptible stall
(a loop of short sleeps, so the step watchdog's ``interrupt_main`` can
break it; a real collective hang blocks in native code and is covered by
the watchdog's hard-exit escalation instead).

Example: ``FLAGS_fault_plan="batch_dispatch:2:RuntimeError,overload:@5:RuntimeError"``
fails the first two serving dispatches typed and sheds the fifth
admission as ``Overloaded``.
"""
from __future__ import annotations

import dataclasses
import logging
import os
import random
import re
from typing import Dict, List, Optional

from ..monitor.lockwitness import make_lock

__all__ = ["FaultPlan", "InjectedFault", "fault_point", "fault_action",
           "stall", "install_plan", "clear_plan", "fault_plan_guard",
           "active_plan", "SITES", "WIRE_SITES", "DATA_ACTIONS"]

logger = logging.getLogger("paddle_tpu_torch.resilience")

SITES = ("compile", "device_put", "step", "ckpt_write", "shard_write",
         "hang", "enqueue", "batch_dispatch", "overload", "device_lost",
         "wire_connect", "wire_response", "wire_stream")

# sites whose faults are performed by the CALL SITE (fault_action): the
# fleet wire layer can drop/stall/corrupt, which a raised exception
# cannot express
WIRE_SITES = frozenset({"wire_connect", "wire_response", "wire_stream"})
DATA_ACTIONS = ("drop", "stall", "corrupt")

# injected exceptions carry this mixin so retry/give-up handlers can tell a
# scripted fault from a real infrastructure error (real errors keep their
# pre-resilience behavior; injected ones must propagate for the chaos gate)
class InjectedFault(Exception):
    pass


_BASES = {"RuntimeError": RuntimeError, "OSError": OSError,
          "IOError": OSError, "TimeoutError": TimeoutError,
          "ConnectionError": ConnectionError}
_INJECTED_CLS: Dict[str, type] = {}


def _injected_class(name: str) -> type:
    if name not in _INJECTED_CLS:
        base = _BASES[name]
        _INJECTED_CLS[name] = type(f"Injected{base.__name__}",
                                   (base, InjectedFault), {})
    return _INJECTED_CLS[name]


_RULE_RE = re.compile(r"^(?P<site>[a-z_]+):(?P<when>@?\d+|p(?:0?\.\d+|1(?:\.0+)?))"
                      r":(?P<action>[A-Za-z_]+)$")


@dataclasses.dataclass
class _Rule:
    site: str
    action: str          # "kill" or an exception class name
    count: Optional[int] = None   # fire on the first N hits
    at: Optional[int] = None      # fire exactly on hit #K
    prob: Optional[float] = None  # fire with probability p per hit

    def fires(self, hit: int, rng: random.Random) -> bool:
        if self.at is not None:
            return hit == self.at
        if self.count is not None:
            return hit <= self.count
        return rng.random() < (self.prob or 0.0)


class FaultPlan:
    """A parsed, seeded fault schedule. Hit counters are per-plan (and the
    plan is per-process), so the same spec replays the same faults. Hit
    accounting is lock-guarded: serving probes ``enqueue`` from concurrent
    submitter threads, and a torn counter would make an ``@K`` rule fire
    twice or never."""

    def __init__(self, spec: str = "", seed: int = 0):
        import threading

        self.spec = spec or ""
        self.seed = int(seed)
        self.rules: Dict[str, List[_Rule]] = {}
        self.hits: Dict[str, int] = {}
        self.fired: List[tuple] = []   # (site, hit, action) audit trail
        self._rng = random.Random(self.seed)
        self._lock = make_lock("FaultPlan._lock")
        for part in filter(None, (p.strip() for p in self.spec.split(","))):
            m = _RULE_RE.match(part)
            if not m:
                raise ValueError(
                    f"FLAGS_fault_plan: cannot parse rule '{part}' — expected"
                    f" site:N:action, site:@K:action or site:pX:action")
            site, when, action = m.group("site", "when", "action")
            if site not in SITES:
                raise ValueError(f"FLAGS_fault_plan: unknown site '{site}' "
                                 f"(known: {', '.join(SITES)})")
            if action not in ("kill", "hang") \
                    and action not in DATA_ACTIONS \
                    and action not in _BASES:
                raise ValueError(
                    f"FLAGS_fault_plan: unknown action '{action}' (known: "
                    f"kill, hang, {', '.join(DATA_ACTIONS)}, "
                    f"{', '.join(sorted(_BASES))})")
            if action in DATA_ACTIONS and site not in WIRE_SITES:
                raise ValueError(
                    f"FLAGS_fault_plan: action '{action}' is a data-plane "
                    f"wire action — only the wire sites "
                    f"({', '.join(sorted(WIRE_SITES))}) can perform it")
            rule = _Rule(site=site, action=action)
            if when.startswith("@"):
                rule.at = int(when[1:])
            elif when.startswith("p"):
                rule.prob = float(when[1:])
            else:
                rule.count = int(when)
            self.rules.setdefault(site, []).append(rule)

    @property
    def active(self) -> bool:
        return bool(self.rules)

    def _fire(self, site: str):
        """Record one pass through ``site`` under the plan lock; returns
        ``(rule, hit_number)`` when a rule fired, else ``None``. The
        ``fired`` audit trail records every fired rule (including the
        data-plane wire actions the call site performs itself)."""
        rules = self.rules.get(site)
        if not rules:
            return None
        with self._lock:
            self.hits[site] = k = self.hits.get(site, 0) + 1
            fired_rule = next(
                (r for r in rules if r.fires(k, self._rng)), None)
            if fired_rule is not None:
                self.fired.append((site, k, fired_rule.action))
        return None if fired_rule is None else (fired_rule, k)

    def hit(self, site: str) -> None:
        """Probe ``site``; perform the scheduled action if a rule fires
        (raise an injected exception or kill the process). Counting and
        rule evaluation run under the plan lock; the action itself runs
        outside it (a ``hang`` must never stall other threads' probes)."""
        fired = self._fire(site)
        if fired is None:
            return
        rule, k = fired
        if rule.action in DATA_ACTIONS:
            # a data-plane action reaching a raise-style probe would be a
            # plan/call-site mismatch (parse validation pins these to the
            # wire sites, which probe via action()); log, never crash
            logger.warning("fault_plan: data action '%s' fired at "
                           "fault_point site '%s' — ignored (probe via "
                           "fault_action)", rule.action, site)
            return
        self._perform(rule, site, k)

    def action(self, site: str) -> Optional[str]:
        """Probe ``site`` for the wire call sites: a fired data-plane
        action (``drop``/``stall``/``corrupt``) is RETURNED for the call
        site to perform; exception/kill/hang actions are performed here
        exactly like :meth:`hit`. ``None`` = nothing fired."""
        fired = self._fire(site)
        if fired is None:
            return None
        rule, k = fired
        if rule.action in DATA_ACTIONS:
            from .. import monitor as _monitor

            if _monitor.enabled():
                _monitor.counter(
                    "resilience_faults_injected_total",
                    "faults fired by the FLAGS_fault_plan schedule").labels(
                    site=site, action=rule.action).inc()
            logger.warning("fault_plan: wire action '%s' at site '%s' "
                           "(hit #%d)", rule.action, site, k)
            return rule.action
        self._perform(rule, site, k)
        return None

    def _perform(self, rule: _Rule, site: str, k: int) -> None:
        from .. import monitor as _monitor

        if _monitor.enabled():
            _monitor.counter(
                "resilience_faults_injected_total",
                "faults fired by the FLAGS_fault_plan schedule").labels(
                site=site, action=rule.action).inc()
        if rule.action == "kill":
            logger.warning("fault_plan: KILL at site '%s' (hit #%d)",
                           site, k)
            os._exit(137)
        if rule.action == "hang":
            import time

            logger.warning("fault_plan: HANG at site '%s' (hit #%d) — "
                           "stalling until interrupted", site, k)
            # short sleeps so a pending interrupt (the watchdog's
            # interrupt_main, or its cross-thread async raise) is
            # delivered between iterations; a single long sleep would
            # ride out the interrupt flag in C
            while True:
                time.sleep(0.02)
        logger.warning("fault_plan: injecting %s at site '%s' (hit #%d)",
                       rule.action, site, k)
        raise _injected_class(rule.action)(
            f"[resilience] injected {rule.action} at site '{site}' "
            f"(hit #{k} of plan '{self.spec}')")


# -- active-plan resolution -------------------------------------------------
# explicit install_plan wins; otherwise FLAGS_fault_plan/FLAGS_fault_seed is
# parsed lazily and cached on the (spec, seed) pair.

_installed: Optional[FaultPlan] = None
_flag_cache: Optional[tuple] = None   # (spec, seed, plan)


def install_plan(plan: Optional[FaultPlan]) -> None:
    global _installed
    _installed = plan


def clear_plan() -> None:
    install_plan(None)


def active_plan() -> Optional[FaultPlan]:
    if _installed is not None:
        return _installed if _installed.active else None
    from ..flags import flag

    spec = flag("fault_plan")
    if not spec:
        return None
    seed = int(flag("fault_seed"))
    global _flag_cache
    if _flag_cache is None or _flag_cache[:2] != (spec, seed):
        _flag_cache = (spec, seed, FaultPlan(spec, seed))
    return _flag_cache[2]


def fault_point(site: str) -> None:
    """The injection probe. No active plan -> a dict lookup and return."""
    plan = active_plan()
    if plan is not None:
        plan.hit(site)


def fault_action(site: str) -> Optional[str]:
    """The wire-site probe: returns a fired data-plane action
    (``drop``/``stall``/``corrupt``) for the call site to perform, raises
    injected exceptions exactly like :func:`fault_point`, or returns
    ``None`` when nothing fired."""
    plan = active_plan()
    if plan is None:
        return None
    return plan.action(site)


def stall(seconds: Optional[float] = None) -> None:
    """The ``stall`` wire action: sleep ``FLAGS_fault_stall_s`` (or an
    explicit ``seconds``) in short slices, so signal delivery and
    interpreter shutdown stay responsive while a stalling peer is being
    modeled."""
    import time

    if seconds is None:
        from ..flags import flag

        seconds = float(flag("fault_stall_s"))
    deadline = time.monotonic() + max(0.0, seconds)
    while True:
        left = deadline - time.monotonic()
        if left <= 0:
            return
        time.sleep(min(0.05, left))


class fault_plan_guard:
    """``with fault_plan_guard("compile:2:RuntimeError"):`` — install a plan
    for a test body, restoring the previous plan (and flag cache) on exit."""

    def __init__(self, spec_or_plan, seed: int = 0):
        self._plan = (spec_or_plan if isinstance(spec_or_plan, FaultPlan)
                      else FaultPlan(spec_or_plan, seed))

    def __enter__(self) -> FaultPlan:
        self._prev = _installed
        install_plan(self._plan)
        return self._plan

    def __exit__(self, *exc):
        install_plan(self._prev)
        return False
