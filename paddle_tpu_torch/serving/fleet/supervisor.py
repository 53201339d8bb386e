"""Replica supervisor: the fleet's self-healing process manager.

Counterpart of ``paddle_tpu/serving/fleet/supervisor.py``. This module
owns replica subprocesses end-to-end, as a deployment where preemption
and restart are routine requires:

* **spawn** — ``python -m paddle_tpu_torch.serving.fleet.replica`` per
  replica (on the supervisor's ``device``: ``cuda`` unless it says
  ``cpu``), stderr appended to one log per replica id across restarts,
  stdout event stream parsed live;
* **ready** — the replica's ``ready`` JSON event registers it with the
  :class:`~.router.FleetRouter` (``add_replica`` first time,
  ``reassign_replica`` on restart — same id, NEW port) and triggers one
  ``poll_now()`` so a restarted replica is fresh capacity within one
  poll. Restarts come up warm through the shared AOT executable cache
  (``--aot-cache``);
* **exit classification** — from the replica's ``exit`` event when one
  exists (the crash path emits it too), else from the exit code:
  ``drain`` (supervisor-requested or SIGTERM-graceful, never
  restarted when requested), ``crash`` (exit event with
  ``reason=crash`` or an unexpected nonzero exit), ``kill`` (SIGKILL /
  ``os._exit`` — no exit event, signal-style return code),
  ``ready_timeout`` (never became ready);
* **restart with backoff** — exponential + seeded jitter via the SAME
  :class:`~paddle_tpu_torch.resilience.retry.RetryPolicy` the transient-site
  retries use (``supervisor_restarts_total{reason}``);
* **crash-loop breaker** — more than ``max_restarts`` restarts inside
  ``restart_window_s`` RETIRES the replica with a typed
  :class:`ReplicaCrashLoop` (stored on the handle, raised by
  :meth:`ReplicaSupervisor.check`, removed from the router) — never a
  silent restart spin.

A crashed replica must be restarted within its backoff budget and serve
again, and a forced crash-loop must retire typed. docs/SERVING.md "Fleet
self-healing" has the state machine.
"""
from __future__ import annotations

import dataclasses
import json
import logging
import os
import random
import signal
import subprocess
import sys
import threading
import time
import zlib
from typing import Callable, Dict, List, Optional, Sequence

from ... import monitor as _monitor
from ...resilience.retry import RetryPolicy
from ..engine import ServingError
from .router import FleetRouter

__all__ = ["ReplicaSupervisor", "SupervisorConfig", "SupervisedReplica",
           "ReplicaCrashLoop"]

logger = logging.getLogger("paddle_tpu_torch.serving.fleet")


class ReplicaCrashLoop(ServingError):
    """A replica restarted ``restarts`` times inside ``window_s`` seconds
    and was RETIRED: restarting a deterministically-crashing replica any
    further is an outage amplifier, not healing. Typed and stored on the
    replica's handle (``handle.error``); :meth:`ReplicaSupervisor.check`
    raises it."""

    def __init__(self, msg: str, replica: str = "", restarts: int = 0,
                 window_s: float = 0.0):
        self.replica = replica
        self.restarts = restarts
        self.window_s = window_s
        super().__init__(msg)


@dataclasses.dataclass
class SupervisorConfig:
    """Supervision knobs. ``restart=False`` is the chaos gate's negative
    control: spawn once, never heal — the gate must provably fail."""

    max_restarts: int = 3          # restarts inside restart_window_s ...
    restart_window_s: float = 60.0  # ... before the crash-loop retire
    backoff_base_s: float = 0.25   # exponential restart backoff (seeded
    backoff_max_s: float = 5.0     # jitter via resilience RetryPolicy)
    ready_timeout_s: float = 240.0  # spawn -> ready bound (cold compile)
    exit_grace_s: float = 30.0     # SIGTERM drain wait before SIGKILL
    seed: int = 0
    restart: bool = True
    # fleet-shared flags, passed to EVERY spawned replica as
    # ``--set-flag name=value`` pairs: how one autotune CostDatabase
    # (FLAGS_autotune_db — flock-merge safe) and one AOT cache warm the
    # whole fleet, so a scale-out replica compiles straight to
    # best-known configs instead of re-measuring
    shared_flags: Optional[Dict[str, str]] = None
    # where every spawned replica runs: "cuda" (CUDAPlace(0), the port's
    # default) or "cpu" (asked for explicitly, as the CPU tests do)
    device: str = "cuda"


class SupervisedReplica:
    """One supervised replica's live state (thread-safe reads; the
    supervisor's monitor thread writes). ``state``: ``spawning`` ->
    ``ready`` -> (``backoff`` -> ``spawning``)* -> ``retired`` |
    ``stopped`` | ``down``."""

    def __init__(self, replica_id: str, model: str, aot_dir: str,
                 extra_args: Sequence[str],
                 initial_extra_args: Sequence[str], host: str):
        self.replica_id = replica_id
        self.model = model
        self.aot_dir = aot_dir
        self.extra_args = list(extra_args)
        self.initial_extra_args = list(initial_extra_args)
        self.host = host
        self.state = "spawning"
        self.proc: Optional[subprocess.Popen] = None
        self.port: Optional[int] = None
        self.spawns = 0                 # completed spawn attempts
        self.restarts = 0               # restarts performed (total)
        self.restart_times: List[float] = []   # monotonic, window-pruned
        self.last_exit: Optional[dict] = None  # {"rc", "reason", ...}
        self.ready_info: Optional[dict] = None
        self.exit_info: Optional[dict] = None  # last parsed exit event
        self.error: Optional[ReplicaCrashLoop] = None
        self.events: List[tuple] = []   # (monotonic, kind, detail) audit
        self.stop_requested = False
        self.drain_requested = False
        self._ready_ev = threading.Event()
        self._retired_ev = threading.Event()
        self.thread: Optional[threading.Thread] = None

    def note(self, kind: str, detail: str = "") -> None:
        self.events.append((time.monotonic(), kind, detail))
        logger.info("supervisor[%s]: %s %s", self.replica_id, kind, detail)

    def wait_ready(self, timeout: Optional[float] = None) -> dict:
        """Block until the replica is ready AND registered with the
        router (``state == "ready"``). A retired replica raises its
        typed :class:`ReplicaCrashLoop` immediately — never a silent
        wait on a replica that will not come."""
        deadline = (None if timeout is None
                    else time.monotonic() + timeout)
        while True:
            if self.error is not None:
                raise self.error          # retired: fail fast, typed
            if self._ready_ev.is_set() and self.state == "ready":
                return dict(self.ready_info or {})
            if self.state in ("down", "stopped"):
                # spawn-once mode after a crash, or a requested stop:
                # no further incarnation is coming — never a silent wait
                raise RuntimeError(
                    f"supervisor: replica {self.replica_id} is "
                    f"{self.state} and will not become ready "
                    f"(last exit: {self.last_exit})")
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(
                    f"supervisor: replica {self.replica_id} not ready "
                    f"within {timeout:g}s (state={self.state})")
            time.sleep(0.02)

    def wait_retired(self, timeout: Optional[float] = None) -> bool:
        return self._retired_ev.wait(timeout)

    def status(self) -> dict:
        return {"replica_id": self.replica_id, "state": self.state,
                "port": self.port, "spawns": self.spawns,
                "restarts": self.restarts,
                "last_exit": self.last_exit,
                "error": str(self.error) if self.error else None}


class ReplicaSupervisor:
    """See module docstring. ``router=None`` supervises processes without
    routing (tests); ``spawn_command`` overrides the argv builder (tests
    substitute a lightweight stub for the real replica module)."""

    def __init__(self, router: Optional[FleetRouter] = None,
                 config: Optional[SupervisorConfig] = None,
                 log_dir: str = ".",
                 env: Optional[Dict[str, str]] = None,
                 cwd: Optional[str] = None,
                 spawn_command: Optional[
                     Callable[["SupervisedReplica"], List[str]]] = None):
        self.router = router
        self.config = config or SupervisorConfig()
        self.log_dir = log_dir
        self.env = env
        self.cwd = cwd
        self._spawn_command = spawn_command or self._default_command
        self._lock = _monitor.make_lock("ReplicaSupervisor._lock")
        self._stop_ev = threading.Event()
        self.replicas: Dict[str, SupervisedReplica] = {}
        self._aggregator = None   # telemetry plane, see start_telemetry

    # -- public surface --------------------------------------------------
    def add_replica(self, replica_id: str, model: str = "mlp_tiny",
                    aot_dir: str = "", extra_args: Sequence[str] = (),
                    initial_extra_args: Sequence[str] = (),
                    host: str = "127.0.0.1") -> SupervisedReplica:
        """Start supervising one replica. ``extra_args`` ride EVERY
        spawn; ``initial_extra_args`` only the first (how the gate makes
        a replica that crashes once and comes back healthy)."""
        with self._lock:
            if replica_id in self.replicas:
                raise ValueError(f"supervisor: replica id '{replica_id}' "
                                 f"already supervised")
            h = SupervisedReplica(replica_id, model, aot_dir, extra_args,
                                  initial_extra_args, host)
            self.replicas[replica_id] = h
        h.thread = threading.Thread(
            target=self._supervise, args=(h,),
            name=f"paddle_tpu_torch-supervisor-{replica_id}", daemon=True)
        h.thread.start()
        self._gauge_live()
        return h

    def handle(self, replica_id: str) -> SupervisedReplica:
        with self._lock:   # add_replica resizes the dict concurrently
            return self.replicas[replica_id]

    def drain(self, replica_id: str) -> None:
        """Graceful SIGTERM drain of one replica; the supervisor will
        NOT restart it."""
        h = self.handle(replica_id)
        h.drain_requested = True
        h.stop_requested = True
        self._signal(h, signal.SIGTERM)

    def kill(self, replica_id: str) -> None:
        """Chaos helper: SIGKILL the replica process WITHOUT telling the
        supervisor — exactly what an OOM kill or host loss looks like,
        so the restart path is exercised for real."""
        h = self.handle(replica_id)
        if h.proc is not None and h.proc.poll() is None:
            h.proc.kill()

    def _handles(self) -> List[SupervisedReplica]:
        """Snapshot for lock-free iteration (add_replica mutates the
        dict under ``_lock``; iterating it live could tear)."""
        with self._lock:
            return list(self.replicas.values())

    def check(self) -> None:
        """Raise the first typed :class:`ReplicaCrashLoop` any replica
        retired with (the 'never a silent spin' contract)."""
        for h in self._handles():
            if h.error is not None:
                raise h.error

    def status(self) -> Dict[str, dict]:
        return {h.replica_id: h.status() for h in self._handles()}

    def start_telemetry(self, config=None):
        """Attach a :class:`~.telemetry.FleetAggregator` scraping this
        supervisor's router membership (restarted replicas are picked
        up within one scrape, exactly like the routing poll). Returns
        the aggregator, or ``None`` without a router or while
        ``FLAGS_fleet_telemetry`` is off (the disabled plane spawns no
        thread)."""
        from . import telemetry

        if self.router is None or not telemetry.enabled():
            return None
        if self._aggregator is None:
            self._aggregator = telemetry.FleetAggregator.for_router(
                self.router, config)
            self._aggregator.start()
        return self._aggregator

    def stop(self, drain: bool = True) -> None:
        """Stop supervising: no further restarts; drain (or kill) every
        live replica and join the monitor threads."""
        self._stop_ev.set()
        agg, self._aggregator = self._aggregator, None
        if agg is not None:
            agg.stop()
        handles = self._handles()
        for h in handles:
            h.stop_requested = True
            if drain:
                h.drain_requested = True
                self._signal(h, signal.SIGTERM)
            elif h.proc is not None and h.proc.poll() is None:
                h.proc.kill()
        deadline = time.monotonic() + self.config.exit_grace_s
        for h in handles:
            if h.thread is not None:
                h.thread.join(max(0.1, deadline - time.monotonic()))
        for h in handles:
            if h.proc is not None and h.proc.poll() is None:
                logger.warning("supervisor: replica %s did not drain in "
                               "%gs — SIGKILL", h.replica_id,
                               self.config.exit_grace_s)
                h.proc.kill()
            if h.thread is not None:
                h.thread.join(10.0)
        self._gauge_live()

    def __enter__(self) -> "ReplicaSupervisor":
        return self

    def __exit__(self, *exc) -> bool:
        self.stop(drain=True)
        return False

    # -- spawning --------------------------------------------------------
    def _default_command(self, h: SupervisedReplica) -> List[str]:
        cmd = [sys.executable, "-m", "paddle_tpu_torch.serving.fleet.replica",
               "--model", h.model, "--replica-id", h.replica_id,
               "--host", h.host, "--port", "0",
               "--device", self.config.device]
        if h.aot_dir:
            cmd += ["--aot-cache", h.aot_dir]
        # fleet-shared flags ride every spawn, BEFORE the per-replica
        # extras so a replica-specific --set-flag can still override
        for name in sorted(self.config.shared_flags or {}):
            cmd += ["--set-flag",
                    f"{name}={self.config.shared_flags[name]}"]
        cmd += h.extra_args
        if h.spawns == 0:
            cmd += h.initial_extra_args
        return cmd

    def _spawn(self, h: SupervisedReplica) -> subprocess.Popen:
        cmd = self._spawn_command(h)
        os.makedirs(self.log_dir or ".", exist_ok=True)
        log_path = os.path.join(self.log_dir,
                                f"replica_{h.replica_id}.log")
        # append across restarts: one log tells the whole lifecycle story
        log = open(log_path, "a")
        try:
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=log, text=True, env=self.env,
                                    cwd=self.cwd)
        finally:
            log.close()   # the child holds its own fd now
        h.spawns += 1
        h.proc = proc
        h.ready_info = None
        h.exit_info = None
        h._ready_ev.clear()
        h.note("spawn", f"pid {proc.pid} (spawn #{h.spawns})")
        threading.Thread(target=self._read_events, args=(h, proc),
                         daemon=True).start()
        return proc

    def _read_events(self, h: SupervisedReplica,
                     proc: subprocess.Popen) -> None:
        try:
            for line in proc.stdout:
                try:
                    obj = json.loads(line)
                except ValueError:
                    continue
                if obj.get("event") == "ready" and proc is h.proc:
                    h.ready_info = obj
                    h._ready_ev.set()
                elif obj.get("event") == "exit" and proc is h.proc:
                    h.exit_info = obj
        except Exception:                      # pragma: no cover
            pass

    # -- the per-replica supervision loop --------------------------------
    def _supervise(self, h: SupervisedReplica) -> None:
        """Crash-guarded shell: a supervisor bug (unspawnable command,
        unwritable log dir) must surface as a typed retired replica, not
        a silently dead daemon thread with callers stuck in
        ``wait_ready``."""
        try:
            self._supervise_inner(h)
        except Exception as e:
            logger.exception("supervisor: monitor thread for %s DIED",
                             h.replica_id)
            h.error = ReplicaCrashLoop(
                f"supervisor: monitor thread for {h.replica_id} died: "
                f"{type(e).__name__}: {e}", replica=h.replica_id)
            h.state = "retired"
            self._deregister(h)
            h._retired_ev.set()
            self._gauge_live()

    def _supervise_inner(self, h: SupervisedReplica) -> None:
        cfg = self.config
        rng = random.Random((int(cfg.seed) << 16)
                            ^ zlib.crc32(h.replica_id.encode()))
        policy = RetryPolicy(max_attempts=1_000_000,
                             base_delay=cfg.backoff_base_s,
                             max_delay=cfg.backoff_max_s,
                             multiplier=2.0, jitter=0.25, timeout=None)
        while True:
            if h.stop_requested or self._stop_ev.is_set():
                # a drain/stop that landed during the backoff must not
                # cost one more full spawn the caller asked never to run
                h.state = "stopped"
                self._deregister(h)
                self._gauge_live()
                return
            h.state = "spawning"
            proc = self._spawn(h)
            reason = self._run_one_incarnation(h, proc)
            h.last_exit = {"rc": proc.returncode, "reason": reason,
                           "exit_event": h.exit_info}
            h.note("exit", f"rc={proc.returncode} reason={reason}")
            if h.stop_requested or self._stop_ev.is_set():
                h.state = "stopped"
                self._deregister(h)
                self._gauge_live()
                return
            if not cfg.restart:
                # negative-control / spawn-once mode: the replica stays
                # down — loudly, with the classification on record
                h.state = "down"
                self._deregister(h)
                self._gauge_live()
                logger.error("supervisor: replica %s is DOWN (%s) and "
                             "restarts are disabled", h.replica_id, reason)
                return
            # crash-loop breaker BEFORE the restart: N restarts inside
            # the window retire the replica typed, never a silent spin
            now = time.monotonic()
            h.restart_times = [t for t in h.restart_times
                               if now - t < cfg.restart_window_s]
            if len(h.restart_times) >= cfg.max_restarts:
                h.error = ReplicaCrashLoop(
                    f"supervisor: replica {h.replica_id} crash-looped — "
                    f"{len(h.restart_times)} restart(s) inside "
                    f"{cfg.restart_window_s:g}s (last exit: {reason}, "
                    f"rc={proc.returncode}); RETIRED",
                    replica=h.replica_id,
                    restarts=len(h.restart_times),
                    window_s=cfg.restart_window_s)
                h.state = "retired"
                self._deregister(h)
                h._retired_ev.set()
                self._gauge_live()
                if _monitor.enabled():
                    _monitor.counter(
                        "supervisor_crash_loops_total",
                        "replicas retired by the crash-loop breaker"
                    ).labels(replica=h.replica_id).inc()
                logger.error("%s", h.error)
                return
            h.restart_times.append(now)
            h.restarts += 1
            delay = policy.delay(len(h.restart_times), rng)
            if _monitor.enabled():
                _monitor.counter(
                    "supervisor_restarts_total",
                    "replica restarts performed by the supervisor, by "
                    "exit classification").labels(reason=reason).inc()
            h.state = "backoff"
            h.note("restart", f"#{h.restarts} after {reason}, backoff "
                              f"{delay:.2f}s")
            # sliced wait: a per-replica drain() (no global event) must
            # also cut the backoff short; the loop top then exits with
            # the dead incarnation deregistered
            end = time.monotonic() + delay
            while time.monotonic() < end and not h.stop_requested:
                if self._stop_ev.wait(min(0.05,
                                          max(0.0,
                                              end - time.monotonic()))):
                    break

    def _run_one_incarnation(self, h: SupervisedReplica,
                             proc: subprocess.Popen) -> str:
        """Wait for ready (register) then exit; returns the exit
        classification: ``drain`` / ``crash`` / ``kill`` /
        ``ready_timeout``."""
        cfg = self.config
        deadline = time.monotonic() + cfg.ready_timeout_s
        while True:
            if h._ready_ev.wait(0.05):
                break
            if proc.poll() is not None:
                return self._classify_exit(h, proc)
            if time.monotonic() > deadline:
                logger.error("supervisor: replica %s not ready within "
                             "%gs — killing the spawn", h.replica_id,
                             cfg.ready_timeout_s)
                proc.kill()
                self._wait(proc, 10.0)
                return "ready_timeout"
            if h.stop_requested or self._stop_ev.is_set():
                # stop arrived while this incarnation was still coming
                # up: it may never have been signalled — do it here
                self._signal(h, signal.SIGTERM)
                if self._wait(proc, cfg.exit_grace_s) is None:
                    proc.kill()
                    self._wait(proc, 10.0)
                return self._classify_exit(h, proc)
        # ready: register as (fresh) capacity — within one poll. The
        # registration happens BEFORE the state flips to "ready", so
        # wait_ready() implies "routable through the router too".
        h.port = int(h.ready_info["port"])
        if self.router is not None:
            self.router.reassign_replica(h.replica_id, h.host, h.port)
            self.router.poll_now()
        h.state = "ready"
        h.note("ready", f"port {h.port} time_to_ready_s="
                        f"{h.ready_info.get('time_to_ready_s')}")
        proc.wait()
        # give the event-reader thread a beat to parse a final exit event
        for _ in range(20):
            if h.exit_info is not None:
                break
            time.sleep(0.05)
        return self._classify_exit(h, proc)

    @staticmethod
    def _classify_exit(h: SupervisedReplica,
                       proc: subprocess.Popen) -> str:
        rc = proc.returncode
        ev = h.exit_info or {}
        if ev.get("reason") == "drain" and rc == 0:
            return "drain"
        if ev.get("reason") == "crash":
            return "crash"
        if rc is not None and (rc < 0 or rc in (137, 124)):
            # signal-style death without an exit event: SIGKILL/OOM or
            # the 'kill' fault action's os._exit(137)
            return "kill"
        if rc == 0:
            return "drain"
        return "crash"

    @staticmethod
    def _wait(proc: subprocess.Popen,
              timeout: float) -> Optional[int]:
        """``Popen.wait`` that returns ``None`` on timeout instead of
        raising."""
        try:
            return proc.wait(timeout)
        except subprocess.TimeoutExpired:
            return None

    def _deregister(self, h: SupervisedReplica) -> None:
        if self.router is not None:
            self.router.remove_replica(h.replica_id)

    def _signal(self, h: SupervisedReplica, sig) -> None:
        if h.proc is not None and h.proc.poll() is None:
            try:
                h.proc.send_signal(sig)
            except OSError:                    # pragma: no cover
                pass

    def _gauge_live(self) -> None:
        if _monitor.enabled():
            _monitor.gauge(
                "supervisor_replicas_live",
                "supervised replicas currently spawning/ready/backoff"
            ).set(sum(1 for x in self._handles()
                      if x.state in ("spawning", "ready", "backoff")))
