"""Fleet autoscaler: the control loop that closes ROADMAP item 5
(docs/SERVING.md "Fleet control loop").

Every sensor and actuator already existed — this module connects them.
:class:`FleetAutoscaler` reads three sensor families each tick:

* the router's per-replica **pressure snapshots** (``queue_depth`` /
  ``degraded`` / ``open_buckets``, polled by ``FleetRouter``),
* the per-class **SLO burn state** (``ok`` / ``warning`` / ``burning``
  from the engines' ``SloBurnTracker``, via the FleetAggregator's
  counter-reset-aware fleet rollup when one is attached, else the
  router's health-poll worst-state), and
* the **supervisor's replica states** (spawning / ready / backoff),

and drives exactly two actuators: ``ReplicaSupervisor.add_replica``
(scale-out, warm through the fleet-shared AOT cache + autotune
CostDatabase carried by ``SupervisorConfig.shared_flags``) and
``ReplicaSupervisor.drain`` (scale-in, strictly the graceful-preemption
path: the victim flips ready-false, finishes everything admitted, exits
0, and the fleet ledger stays ``exact`` throughout).

**A decision is never silent.** Every tick ends in an act, a typed
refusal (``at_max_replicas`` / ``at_min_replicas`` / ``cooldown`` /
``spawn_budget_spent``) or a hold, and acts/refusals are metered
(``autoscaler_decisions_total{action,reason}``) and appended to a
bounded audit trail (consecutive repeats coalesce with a count — a
10-minute cooldown does not scroll 600 identical lines).

**The loop cannot flap.** Scale-out needs the hot signal sustained for
``hot_sustain_s``; scale-in needs calm sustained for ``calm_sustain_s``;
any act starts a ``cooldown_s`` window refusing further acts; and an
in-flight drain refuses concurrent scale decisions (typed ``cooldown``)
until the victim is fully retired. The clock is injectable
(``_now``, the ``SloBurnTracker`` idiom) so the hysteresis is
regression-testable without sleeping.

Lock discipline: the autoscaler lock is a leaf — it is never held
across a supervisor, router or aggregator call (those have their own
locks; holding ours across theirs would order-invert against the poll
threads). ``tick()`` is serialized by a dedicated tick lock so a
background loop and a manual tick cannot double-actuate.
"""
from __future__ import annotations

import dataclasses
import logging
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Sequence

from ... import monitor as _monitor
from ...flags import flag as _flag

__all__ = ["AutoscalerConfig", "FleetAutoscaler"]

logger = logging.getLogger("paddle_tpu_torch.serving.fleet.autoscaler")

# supervisor states that count toward the replica budget (a replica in
# backoff is still owned capacity — it will come back or retire typed)
_LIVE_STATES = ("spawning", "ready", "backoff")

# typed refusal reasons (the only reasons a wanted act does not happen)
REFUSALS = ("at_max_replicas", "at_min_replicas", "cooldown",
            "spawn_budget_spent")


def _flag_default(value, name):
    return _flag(name) if value is None else value


@dataclasses.dataclass
class AutoscalerConfig:
    """Control-loop knobs. ``None`` fields resolve from the
    ``FLAGS_serving_autoscale_*`` family (docs/SERVING.md flag table),
    mirroring ``ServingConfig``."""

    min_replicas: Optional[int] = None
    max_replicas: Optional[int] = None
    interval_s: Optional[float] = None
    cooldown_s: Optional[float] = None
    hot_sustain_s: Optional[float] = None
    calm_sustain_s: Optional[float] = None
    max_inflight_spawns: Optional[int] = None
    queue_high: Optional[int] = None

    def resolve(self) -> "AutoscalerConfig":
        r = AutoscalerConfig(
            min_replicas=int(_flag_default(
                self.min_replicas, "serving_autoscale_min_replicas")),
            max_replicas=int(_flag_default(
                self.max_replicas, "serving_autoscale_max_replicas")),
            interval_s=float(_flag_default(
                self.interval_s, "serving_autoscale_interval_s")),
            cooldown_s=float(_flag_default(
                self.cooldown_s, "serving_autoscale_cooldown_s")),
            hot_sustain_s=float(_flag_default(
                self.hot_sustain_s, "serving_autoscale_hot_sustain_s")),
            calm_sustain_s=float(_flag_default(
                self.calm_sustain_s, "serving_autoscale_calm_sustain_s")),
            max_inflight_spawns=int(_flag_default(
                self.max_inflight_spawns,
                "serving_autoscale_max_inflight_spawns")),
            queue_high=int(_flag_default(
                self.queue_high, "serving_autoscale_queue_high")),
        )
        if r.min_replicas < 0:
            raise ValueError(f"autoscaler: min_replicas must be >= 0, "
                             f"got {r.min_replicas}")
        if r.max_replicas < max(1, r.min_replicas):
            raise ValueError(
                f"autoscaler: max_replicas must be >= "
                f"max(1, min_replicas), got {r.max_replicas} with "
                f"min_replicas {r.min_replicas}")
        if r.max_inflight_spawns < 1:
            raise ValueError(f"autoscaler: max_inflight_spawns must be "
                             f">= 1, got {r.max_inflight_spawns}")
        return r


class FleetAutoscaler:
    """See module docstring. ``supervisor`` needs ``add_replica`` /
    ``drain`` / ``status()`` (duck-typed — tests substitute fakes);
    ``router`` defaults to the supervisor's; ``aggregator`` (optional)
    upgrades the burn sensor from the router's worst-state to the
    fleet-rollup per-class view. ``model`` / ``aot_dir`` /
    ``extra_args`` template every scale-out spawn."""

    def __init__(self, supervisor, router=None, aggregator=None,
                 config: Optional[AutoscalerConfig] = None, *,
                 model: str = "mlp_tiny", aot_dir: str = "",
                 extra_args: Sequence[str] = (),
                 replica_id_prefix: str = "as",
                 _now=time.monotonic):
        self.supervisor = supervisor
        self.router = router if router is not None \
            else getattr(supervisor, "router", None)
        self.aggregator = aggregator
        self.config = (config or AutoscalerConfig()).resolve()
        self.model = model
        self.aot_dir = aot_dir
        self.extra_args = list(extra_args)
        self.replica_id_prefix = replica_id_prefix
        self._now = _now

        # serializes tick(); never acquired by readers
        self._tick_lock = _monitor.make_lock("FleetAutoscaler._tick_lock")
        # leaf lock for the state below — NEVER held across a
        # supervisor/router/aggregator call
        self._lock = _monitor.make_lock("FleetAutoscaler._lock")
        self._hot_since: Optional[float] = None
        self._calm_since: Optional[float] = None
        self._last_action_t: Optional[float] = None
        self._spawned: List[str] = []       # autoscaler-spawned, LIFO
        self._draining: Dict[str, float] = {}   # victim -> drain start
        self._seq = 0
        self._audit: deque = deque(maxlen=256)
        self._last_decision: Optional[dict] = None
        self._last_sense: Dict[str, Any] = {}

        self._stop_ev = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- control loop ----------------------------------------------------
    def start(self) -> "FleetAutoscaler":
        """Spawn the background tick thread (``interval_s`` cadence).
        Tests usually skip this and drive :meth:`tick` directly."""
        if self._thread is not None:
            return self
        self._stop_ev.clear()
        self._thread = threading.Thread(
            target=self._loop, name="paddle_tpu_torch-fleet-autoscaler",
            daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop_ev.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(10.0)

    def _loop(self) -> None:
        while not self._stop_ev.wait(self.config.interval_s):
            try:
                self.tick()
            except Exception:
                # the control loop must outlive a torn sensor read (a
                # replica dying mid-scrape); the failure is logged, the
                # next tick re-senses from scratch
                logger.exception("autoscaler: tick failed; continuing")

    def tick(self) -> dict:
        """One full sense -> decide -> act cycle. Returns the decision
        record (also kept as ``status()['last_decision']`` when it is an
        act or a refusal)."""
        with self._tick_lock:
            now = self._now()
            sense = self._sense(now)
            decision = self._decide(sense, now)
            self._publish_gauges(sense)
            return decision

    # -- sensors ---------------------------------------------------------
    def _sense(self, now: float) -> Dict[str, Any]:
        status = self.supervisor.status()
        live = [rid for rid, st in status.items()
                if st.get("state") in _LIVE_STATES]
        spawning = [rid for rid, st in status.items()
                    if st.get("state") == "spawning"]
        # prune drains whose victim fully retired (state left the live
        # set): only then may the cooldown-by-drain release
        with self._lock:
            for rid in list(self._draining):
                if status.get(rid, {}).get("state") not in _LIVE_STATES:
                    del self._draining[rid]
            draining = list(self._draining)

        pressure, press_why = self._sense_pressure()
        burn, classes = self._sense_burn()
        hot = pressure or burn
        with self._lock:
            if hot:
                if self._hot_since is None:
                    self._hot_since = now
                self._calm_since = None
            else:
                if self._calm_since is None:
                    self._calm_since = now
                self._hot_since = None
            sense = {
                "replicas": len(live), "live": sorted(live),
                "spawning": len(spawning), "draining": draining,
                "pressure": pressure, "pressure_why": press_why,
                "burning": burn, "slo_classes": classes, "hot": hot,
                "hot_for_s": (now - self._hot_since
                              if self._hot_since is not None else 0.0),
                "calm_for_s": (now - self._calm_since
                               if self._calm_since is not None else 0.0),
            }
            self._last_sense = sense
        return sense

    def _sense_pressure(self):
        """True when any polled-ready replica shows admission pressure:
        deep queue, degraded mode, or open breaker buckets."""
        if self.router is None:
            return False, ""
        for rep in list(self.router.replicas):
            snap = rep.snapshot()
            if not snap.get("ready"):
                continue
            if snap.get("queue_depth", 0) >= self.config.queue_high:
                return True, (f"{rep.replica_id}: queue_depth "
                              f"{snap['queue_depth']} >= "
                              f"{self.config.queue_high}")
            if snap.get("degraded"):
                return True, f"{rep.replica_id}: degraded"
            if snap.get("open_buckets", 0) > 0:
                return True, (f"{rep.replica_id}: "
                              f"{snap['open_buckets']} open buckets")
        return False, ""

    def _sense_burn(self):
        """(any class burning?, per-class worst state map). Prefers the
        aggregator's exact fleet rollup; falls back to the router
        health-poll's per-replica worst state."""
        classes: Dict[str, str] = {}
        if self.aggregator is not None:
            snap = self.aggregator.snapshot()
            for rec in snap.get("replicas", {}).values():
                for name, cls in ((rec.get("slo") or {}).get("classes")
                                  or {}).items():
                    classes[name] = _worst(classes.get(name),
                                           cls.get("state"))
            if not classes:
                state = snap.get("fleet", {}).get("slo_state")
                if state:
                    classes["_fleet"] = state
        elif self.router is not None:
            for rep in list(self.router.replicas):
                state = rep.snapshot().get("slo_state")
                if state and state != "unknown":
                    classes["_fleet"] = _worst(classes.get("_fleet"),
                                               state)
        return any(s == "burning" for s in classes.values()), classes

    # -- decisions -------------------------------------------------------
    def _decide(self, sense: Dict[str, Any], now: float) -> dict:
        cfg = self.config
        if sense["hot"] and sense["hot_for_s"] >= cfg.hot_sustain_s:
            why = ("slo_burn" if sense["burning"]
                   else f"pressure ({sense['pressure_why']})")
            if sense["replicas"] >= cfg.max_replicas:
                return self._record("refuse_scale_out", "at_max_replicas",
                                    f"{sense['replicas']} replicas >= "
                                    f"max {cfg.max_replicas}; hot: {why}",
                                    now)
            if sense["spawning"] >= cfg.max_inflight_spawns:
                return self._record(
                    "refuse_scale_out", "spawn_budget_spent",
                    f"{sense['spawning']} spawns in flight >= "
                    f"{cfg.max_inflight_spawns}; hot: {why}", now)
            refused = self._cooldown_refusal(now)
            if refused:
                return self._record("refuse_scale_out", "cooldown",
                                    f"{refused}; hot: {why}", now)
            return self._scale_out(why, now)
        if (not sense["hot"]
                and sense["calm_for_s"] >= cfg.calm_sustain_s):
            if sense["replicas"] <= cfg.min_replicas:
                # steady state at the floor: holding there forever is
                # the expected calm condition, not a refusal storm worth
                # an audit line per tick — metered, deduped in the audit
                return self._record("refuse_scale_in", "at_min_replicas",
                                    f"{sense['replicas']} replicas <= "
                                    f"min {cfg.min_replicas}", now)
            refused = self._cooldown_refusal(now)
            if refused:
                return self._record("refuse_scale_in", "cooldown",
                                    refused, now)
            victim = self._pick_victim(sense)
            if victim is None:
                return self._record("refuse_scale_in", "at_min_replicas",
                                    "no drainable victim", now)
            return self._scale_in(victim, now)
        return {"action": "hold", "reason": "steady",
                "detail": (f"hot_for {sense['hot_for_s']:.1f}s / "
                           f"calm_for {sense['calm_for_s']:.1f}s"),
                "t": now}

    def _cooldown_refusal(self, now: float) -> str:
        """Non-empty reason string when an act must be refused typed
        ``cooldown``: inside the post-act window, or a drain in flight
        (scale decisions during a drain are exactly the race the
        regression test pins)."""
        with self._lock:
            if self._draining:
                return (f"drain of {sorted(self._draining)} in flight")
            if self._last_action_t is not None:
                since = now - self._last_action_t
                if since < self.config.cooldown_s:
                    return (f"{since:.1f}s since last action < cooldown "
                            f"{self.config.cooldown_s:g}s")
        return ""

    def _pick_victim(self, sense: Dict[str, Any]) -> Optional[str]:
        """LIFO over autoscaler-spawned replicas first (scale in what
        scale-out added), else the newest supervised live replica —
        never one already draining."""
        live = set(sense["live"])
        with self._lock:
            draining = set(self._draining)
            spawned = list(self._spawned)
        for rid in reversed(spawned):
            if rid in live and rid not in draining:
                return rid
        for rid in reversed(list(self.supervisor.status())):
            if rid in live and rid not in draining:
                return rid
        return None

    # -- actuators -------------------------------------------------------
    def _scale_out(self, why: str, now: float) -> dict:
        with self._lock:
            self._seq += 1
            rid = f"{self.replica_id_prefix}{self._seq}"
        # actuate OUTSIDE the lock: add_replica takes supervisor locks
        self.supervisor.add_replica(rid, model=self.model,
                                    aot_dir=self.aot_dir,
                                    extra_args=self.extra_args)
        with self._lock:
            self._spawned.append(rid)
            self._last_action_t = now
        return self._record("scale_out", why, f"spawned {rid}", now,
                            replica=rid)

    def _scale_in(self, victim: str, now: float) -> dict:
        # mark the drain BEFORE signalling: a concurrent tick must see
        # the cooldown the instant the victim starts draining
        with self._lock:
            self._draining[victim] = now
            self._last_action_t = now
        self.supervisor.drain(victim)
        return self._record("scale_in", "calm", f"draining {victim}",
                            now, replica=victim)

    # -- audit + metrics -------------------------------------------------
    def _record(self, action: str, reason: str, detail: str,
                now: float, replica: str = "") -> dict:
        entry = {"t": now, "action": action, "reason": reason,
                 "detail": detail, "count": 1}
        if replica:
            entry["replica"] = replica
        if _monitor.enabled():
            _monitor.counter(
                "autoscaler_decisions_total",
                "autoscaler decisions by action and typed reason "
                "(acts AND refusals — a decision is never silent)"
            ).labels(action=action, reason=reason).inc()
        with self._lock:
            last = self._audit[-1] if self._audit else None
            if (last is not None and last["action"] == action
                    and last["reason"] == reason
                    and last.get("replica") == entry.get("replica")):
                # coalesce the refusal storm; the counter above already
                # took the per-tick increment
                last["count"] += 1
                last["t"] = now
                last["detail"] = detail
            else:
                self._audit.append(entry)
            self._last_decision = dict(entry)
        logger.info("autoscaler: %s (%s) — %s", action, reason, detail)
        return entry

    def _publish_gauges(self, sense: Dict[str, Any]) -> None:
        if not _monitor.enabled():
            return
        _monitor.gauge("autoscaler_replicas",
                       "live replicas the autoscaler counts against "
                       "min/max").set(sense["replicas"])
        _monitor.gauge("autoscaler_hot",
                       "1 while the hot signal (SLO burn or pressure) "
                       "is present").set(1 if sense["hot"] else 0)
        _monitor.gauge("autoscaler_inflight_spawns",
                       "replicas spawned but not yet ready").set(
            sense["spawning"])
        _monitor.gauge("autoscaler_draining",
                       "scale-in drains in flight").set(
            len(sense["draining"]))

    def status(self) -> dict:
        """One snapshot for tooling (``tools/fleet_top.py``): the last
        sense, the last act/refusal, and the audit tail."""
        with self._lock:
            return {
                "config": dataclasses.asdict(self.config),
                "sense": dict(self._last_sense),
                "last_decision": (dict(self._last_decision)
                                  if self._last_decision else None),
                "spawned": list(self._spawned),
                "draining": dict(self._draining),
                "audit": [dict(e) for e in self._audit],
            }


_STATE_RANK = {"ok": 0, "warning": 1, "burning": 2}


def _worst(a: Optional[str], b: Optional[str]) -> str:
    """Worst-state merge over the ok < warning < burning order (unknown
    states rank below ok so they never mask a real signal)."""
    ra = _STATE_RANK.get(a, -1)
    rb = _STATE_RANK.get(b, -1)
    return (a if ra >= rb else b) or "unknown"
