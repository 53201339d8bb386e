"""Fleet telemetry plane: versioned /metrics forms + cross-replica
aggregation (docs/OBSERVABILITY.md "Fleet telemetry plane").

Two halves, mirroring the health plane's replica/router split:

**Replica side** — :func:`metrics_json` renders the monitor registry as
a SCHEMA-VERSIONED JSON document (``METRICS_SCHEMA_VERSION``, key set
frozen exactly like the engine's health payload) that carries what the
Prometheus text form cannot: per-bucket trace exemplars, the SLO burn
state and the per-tenant ledger. The front-end serves both forms on
``GET /metrics`` / ``/metrics.json``.

**Aggregator side** — :class:`FleetAggregator` (router/supervisor side,
the same poll-thread pattern as ``FleetRouter``) scrapes every
replica's ``/metrics`` on an interval and turns N replica registries
into one fleet view:

* **windowed counter deltas** — per-second rates over the scrape
  window, counter-reset aware (a restarted replica's counters drop to
  zero; the delta clamps to the new absolute value instead of going
  negative);
* **exact histogram merge** — request-latency histograms merge
  bucket-wise via :func:`monitor.merge_histogram_snapshots` (fixed
  shared bucket layouts make the merge exact, and mismatched layouts
  are refused, never silently misbucketed), so fleet p50/p99 are
  computed from the SUMMED distribution, not averaged percentiles;
* **rollups** — published back into the LOCAL registry as
  ``fleet_agg_*`` gauges labeled ``{replica=...}`` per replica plus a
  ``replica="_fleet"`` total, so one scrape of the aggregator's own
  process sees the whole fleet;
* **typed scrape failures** — every failure is classified
  (``timeout`` / ``connect`` / ``http_<status>`` / ``corrupt``) and
  counted on ``fleet_scrape_failures_total{replica,kind}``; a failing
  replica DEGRADES to its last good snapshot marked ``stale`` with a
  growing ``scrape_age_s`` — the aggregator itself never crashes on a
  hostile or half-written metrics body.

The whole plane sits behind ``FLAGS_fleet_telemetry`` (default OFF):
``start()`` refuses to spawn the scrape thread while the flag is off,
and the exemplar rings replica-side are never allocated (the observe
path passes ``exemplar=None``), so the disabled path is a true no-op.
"""
from __future__ import annotations

import http.client
import json
import logging
import socket
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

from ... import monitor as _monitor
from ...flags import flag as _flag

__all__ = ["METRICS_SCHEMA_VERSION", "METRICS_SCHEMA_KEYS", "enabled",
           "metrics_json", "AggregatorConfig", "FleetAggregator"]

logger = logging.getLogger("paddle_tpu_torch.serving.fleet")

# the JSON metrics document is a wire contract exactly like the health
# payload: the key set is FROZEN per version — additions bump the
# version and land in both this frozenset and the docs table
# (docs/OBSERVABILITY.md "metrics JSON schema").
METRICS_SCHEMA_VERSION = 1
METRICS_SCHEMA_KEYS = frozenset({
    "schema_version", "replica_id", "families", "exemplars", "slo",
    "tenants"})

# the fleet-total pseudo replica label on fleet_agg_* rollups; "_fleet"
# cannot collide with a real replica id (supervisor ids are r<N>-style)
FLEET_LABEL = "_fleet"

# the histogram the fleet latency rollup merges: the engine-side
# completed-request latency (identical default bucket layout on every
# replica, which is what makes the merge exact)
REQUEST_LATENCY_METRIC = "serving_request_latency_seconds"
OUTCOME_COUNTER = "serving_requests_total"
QUEUE_DEPTH_GAUGE = "serving_queue_depth"

_SLO_STATE_ORDER = ("ok", "warning", "burning")


def enabled() -> bool:
    """The plane's master switch (``FLAGS_fleet_telemetry``)."""
    return _monitor.telemetry_enabled()


# ---------------------------------------------------------------------------
# replica side: the versioned JSON form
# ---------------------------------------------------------------------------

def metrics_json(registry=None, replica_id: str = "",
                 slo: Optional[dict] = None,
                 tenants: Optional[dict] = None) -> dict:
    """The schema-versioned JSON metrics document for one replica.

    ``families`` is ``MetricsRegistry.to_dict()`` verbatim;
    ``exemplars`` maps histogram family name -> list of
    ``{"labels": ..., "buckets": {le: [{"trace_id", "value"}, ...]}}``
    (only label sets that recorded any); ``slo``/``tenants`` are the
    engine's ``slo_state()`` / ``tenant_accounting()`` payloads (None
    for engines without them).
    """
    reg = registry if registry is not None else _monitor.get_registry()
    exemplars: Dict[str, List[dict]] = {}
    for fam in reg.families():
        if fam.kind != "histogram":
            continue
        for labels, child in fam.children():
            ex = child.exemplars()
            if ex:
                exemplars.setdefault(fam.name, []).append(
                    {"labels": labels, "buckets": ex})
    return {
        "schema_version": METRICS_SCHEMA_VERSION,
        "replica_id": replica_id,
        "families": reg.to_dict(),
        "exemplars": exemplars,
        "slo": slo,
        "tenants": tenants,
    }


# ---------------------------------------------------------------------------
# aggregator side
# ---------------------------------------------------------------------------

class _Corrupt(Exception):
    """Internal: the scrape answered 200 with an undecodable body."""


class AggregatorConfig:
    """Scrape knobs. ``mode='json'`` scrapes ``/metrics.json`` (the
    full document: exemplars, SLO, tenants); ``mode='prom'`` scrapes
    the text form and reassembles histograms through the
    ``monitor.promtext`` parser — same rollups, no exemplar/tenant
    sections (the text form does not carry them)."""

    def __init__(self, scrape_interval_s: Optional[float] = None,
                 scrape_timeout_s: float = 2.0, mode: str = "json"):
        if scrape_interval_s is None:
            scrape_interval_s = float(_flag("fleet_scrape_interval_s"))
        if mode not in ("json", "prom"):
            raise ValueError(f"aggregator mode must be 'json' or "
                             f"'prom', got {mode!r}")
        self.scrape_interval_s = float(scrape_interval_s)
        self.scrape_timeout_s = float(scrape_timeout_s)
        self.mode = mode


class FleetAggregator:
    """See module docstring. ``targets`` is a callable returning the
    current ``[(replica_id, "host:port"), ...]`` membership (evaluated
    every poll, so supervisor restarts/reassigns are picked up within
    one scrape), or a ``FleetRouter``-shaped object exposing
    ``.replicas`` — use :meth:`for_router` for that spelling."""

    def __init__(self, targets, config: Optional[AggregatorConfig] = None):
        self.config = config or AggregatorConfig()
        if callable(targets):
            self._targets = targets
        elif hasattr(targets, "replicas"):
            router = targets
            self._targets = lambda: [(r.replica_id, r.address)
                                     for r in router.replicas]
        else:
            fixed = [(str(rid), str(addr)) for rid, addr in targets]
            self._targets = lambda: fixed
        # leaf lock: guards _scrapes only; registry publication happens
        # OUTSIDE it, so this lock never nests around the registry's
        self._lock = _monitor.make_lock("FleetAggregator._lock")
        self._scrapes: Dict[str, dict] = {}
        self._thread: Optional[threading.Thread] = None
        self._stop_ev = threading.Event()

    @classmethod
    def for_router(cls, router,
                   config: Optional[AggregatorConfig] = None
                   ) -> "FleetAggregator":
        return cls(router, config)

    # -- lifecycle -------------------------------------------------------
    def start(self) -> "FleetAggregator":
        """Spawn the scrape thread — a NO-OP while the plane is
        disabled (``FLAGS_fleet_telemetry=0``): no thread, no sockets,
        no registry writes."""
        if not enabled():
            logger.info("fleet aggregator: telemetry plane disabled "
                        "(FLAGS_fleet_telemetry=0) — not starting")
            return self
        if self._thread is not None:
            return self
        self.poll_now()
        self._stop_ev.clear()
        self._thread = threading.Thread(
            target=self._poll_loop, name="paddle_tpu_torch-fleet-agg-scrape",
            daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop_ev.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(self.config.scrape_timeout_s + 2.0)

    def __enter__(self) -> "FleetAggregator":
        return self.start()

    def __exit__(self, *exc) -> bool:
        self.stop()
        return False

    def _poll_loop(self) -> None:
        while not self._stop_ev.wait(self.config.scrape_interval_s):
            try:
                self.poll_now()
            except Exception:
                # the aggregator must never die to one bad poll round —
                # individual scrape failures are already typed; this
                # guards rollup bugs
                logger.exception("fleet aggregator: poll round failed")

    # -- scraping --------------------------------------------------------
    def poll_now(self) -> None:
        """One synchronous scrape of every current target, then rollup
        publication. Safe to call directly (tests, CLI one-shots)."""
        now = time.monotonic()
        records = []
        for replica_id, address in list(self._targets()):
            records.append(self._scrape_one(str(replica_id),
                                            str(address), now))
        with self._lock:
            self._scrapes = {r["replica_id"]: r for r in records}
        self._publish(records, now)

    def _fetch(self, address: str) -> Tuple[int, bytes]:
        host, _, port = address.rpartition(":")
        conn = http.client.HTTPConnection(
            host, int(port), timeout=self.config.scrape_timeout_s)
        try:
            path = ("/metrics.json" if self.config.mode == "json"
                    else "/metrics")
            conn.request("GET", path)
            resp = conn.getresponse()
            return resp.status, resp.read()
        finally:
            conn.close()

    def _parse(self, raw: bytes) -> dict:
        """Decode one 200 body into the JSON-document shape (whatever
        the scrape mode). Anything undecodable is :class:`_Corrupt` —
        a typed scrape failure, never a partial parse."""
        if self.config.mode == "prom":
            try:
                parsed = _monitor.parse_prometheus_text(raw)
            except _monitor.PromParseError as e:
                raise _Corrupt(str(e)) from e
            return {"schema_version": METRICS_SCHEMA_VERSION,
                    "replica_id": "", "exemplars": {}, "slo": None,
                    "tenants": None,
                    "families": _families_from_prom(parsed)}
        try:
            body = json.loads(raw.decode("utf-8"))
        except Exception as e:
            raise _Corrupt(f"not JSON ({type(e).__name__})") from e
        if not isinstance(body, dict):
            raise _Corrupt("metrics body is not a JSON object")
        try:
            version = int(body.get("schema_version", 0))
        except (TypeError, ValueError):
            raise _Corrupt("bad metrics schema_version") from None
        if version > METRICS_SCHEMA_VERSION:
            raise _Corrupt(f"metrics schema_version {version} is newer "
                           f"than this aggregator speaks "
                           f"({METRICS_SCHEMA_VERSION})")
        if not isinstance(body.get("families"), dict):
            raise _Corrupt("metrics body has no families object")
        return body

    def _scrape_one(self, replica_id: str, address: str,
                    now: float) -> dict:
        with self._lock:
            prev = self._scrapes.get(replica_id)
        kind = ""
        body: Optional[dict] = None
        try:
            status, raw = self._fetch(address)
            if status != 200:
                kind = f"http_{status}"
            else:
                body = self._parse(raw)
        except _Corrupt as e:
            kind = "corrupt"
            logger.warning("fleet aggregator: corrupt /metrics from %s "
                           "(%s) — keeping last good snapshot", replica_id,
                           e)
        except (socket.timeout, TimeoutError):
            kind = "timeout"
        except (OSError, http.client.HTTPException):
            kind = "connect"
        if _monitor.enabled():
            _monitor.counter(
                "fleet_scrapes_total",
                "aggregator scrape attempts by replica and result"
            ).labels(replica=replica_id,
                     result="ok" if body is not None else "error").inc()
            if body is None:
                _monitor.counter(
                    "fleet_scrape_failures_total",
                    "aggregator scrape failures by replica and typed "
                    "kind (timeout/connect/http_<status>/corrupt)"
                ).labels(replica=replica_id, kind=kind).inc()
        if body is None:
            # degrade: last good data survives, marked stale with a
            # growing age — never a crash, never silently fresh
            rec = dict(prev) if prev else self._fresh_record(replica_id)
            rec.update(
                replica_id=replica_id, up=False, stale=True, error=kind,
                consecutive_failures=rec.get("consecutive_failures",
                                             0) + 1)
            return rec
        families = body["families"]
        counters = _counter_values(families)
        rates: Dict[str, Dict[Tuple, float]] = {}
        window_s = None
        if prev is not None and prev.get("last_ok_monotonic") is not None:
            window_s = max(1e-9, now - prev["last_ok_monotonic"])
            for name, series in counters.items():
                prev_series = (prev.get("counters") or {}).get(name, {})
                for key, v in series.items():
                    d = v - prev_series.get(key, 0.0)
                    if d < 0:
                        d = v    # counter reset: replica restarted
                    rates.setdefault(name, {})[key] = d / window_s
        return {
            "replica_id": replica_id, "up": True, "stale": False,
            "error": "", "consecutive_failures": 0,
            "last_ok_monotonic": now, "window_s": window_s,
            "counters": counters, "rates": rates,
            "latency": _latency_snapshot(families),
            "outcomes": _outcome_counts(families),
            "queue_depth": _gauge_value(families, QUEUE_DEPTH_GAUGE),
            "slo": body.get("slo"), "tenants": body.get("tenants"),
            "exemplars": body.get("exemplars") or {},
        }

    @staticmethod
    def _fresh_record(replica_id: str) -> dict:
        return {"replica_id": replica_id, "up": False, "stale": True,
                "error": "", "consecutive_failures": 0,
                "last_ok_monotonic": None, "window_s": None,
                "counters": {}, "rates": {}, "latency": None,
                "outcomes": {}, "queue_depth": None, "slo": None,
                "tenants": None, "exemplars": {}}

    # -- rollups ---------------------------------------------------------
    def _publish(self, records: Sequence[dict], now: float) -> None:
        if not _monitor.enabled():
            return
        up = _monitor.gauge(
            "fleet_agg_up",
            "1 when the last scrape of this replica succeeded")
        age = _monitor.gauge(
            "fleet_agg_scrape_age_s",
            "seconds since this replica's last successful scrape "
            "(stale snapshots keep aging)")
        lat = _monitor.gauge(
            "fleet_agg_latency_seconds",
            "request latency quantiles from scraped histograms; "
            "replica='_fleet' is the EXACT bucket-wise merge across "
            "replicas, not an average of percentiles")
        rate = _monitor.gauge(
            "fleet_agg_request_rate",
            "completed requests per second over the scrape window")
        reqs = _monitor.gauge(
            "fleet_agg_requests_total",
            "absolute scraped request-outcome counters; "
            "replica='_fleet' sums all replicas")
        slo_g = _monitor.gauge(
            "fleet_agg_slo_state",
            "scraped SLO state per replica: 0=ok 1=warning 2=burning "
            "(-1 unknown); replica='_fleet' is the worst")
        for rec in records:
            rid = rec["replica_id"]
            up.labels(replica=rid).set(0.0 if rec["stale"] else 1.0)
            last_ok = rec.get("last_ok_monotonic")
            age.labels(replica=rid).set(
                (now - last_ok) if last_ok is not None else -1.0)
            snap = rec.get("latency")
            if snap:
                for q in ("p50", "p99"):
                    v = snap.get(q)
                    if v is not None:
                        lat.labels(replica=rid, q=q).set(v)
            completed_rate = (rec.get("rates", {})
                              .get(OUTCOME_COUNTER, {})
                              .get((("outcome", "completed"),)))
            if completed_rate is not None:
                rate.labels(replica=rid).set(completed_rate)
            for key, v in rec.get("outcomes", {}).items():
                reqs.labels(replica=rid, outcome=key).set(v)
            slo_g.labels(replica=rid).set(_slo_index(rec.get("slo")))
        fleet = self._fleet_rollup(records)
        up.labels(replica=FLEET_LABEL).set(
            sum(1.0 for r in records if not r["stale"]))
        if fleet["latency"]:
            for q in ("p50", "p99"):
                v = fleet["latency"].get(q)
                if v is not None:
                    lat.labels(replica=FLEET_LABEL, q=q).set(v)
        for key, v in fleet["outcomes"].items():
            reqs.labels(replica=FLEET_LABEL, outcome=key).set(v)
        slo_g.labels(replica=FLEET_LABEL).set(fleet["slo_index"])

    def _fleet_rollup(self, records: Sequence[dict]) -> dict:
        """The cross-replica reduction: exact latency merge, outcome
        sums, tenant-ledger sums, worst SLO state. Stale records
        contribute their LAST GOOD data (the honest fleet view while a
        replica is unreachable: known-old beats silently-absent — the
        per-replica ``stale``/``scrape_age_s`` marks carry the caveat)."""
        latencies = [r["latency"] for r in records if r.get("latency")]
        merged = None
        if latencies:
            try:
                merged = _monitor.merge_histogram_snapshots(latencies)
            except ValueError as e:
                # mismatched bucket layouts across replica versions:
                # refuse the merge loudly rather than misbucket
                logger.warning("fleet aggregator: latency merge "
                               "refused: %s", e)
        outcomes: Dict[str, float] = {}
        tenants: Dict[str, dict] = {}
        worst = -1
        for r in records:
            for key, v in (r.get("outcomes") or {}).items():
                outcomes[key] = outcomes.get(key, 0) + v
            for name, t in (r.get("tenants") or {}).items():
                agg = tenants.setdefault(name,
                                         {"outcomes": {},
                                          "occupancy_s": 0.0})
                for o, n in (t.get("outcomes") or {}).items():
                    agg["outcomes"][o] = agg["outcomes"].get(o, 0) + n
                agg["occupancy_s"] += float(t.get("occupancy_s") or 0.0)
                agg["quota_sheds"] = (agg.get("quota_sheds", 0)
                                      + int(t.get("quota_sheds") or 0))
            worst = max(worst, _slo_index(r.get("slo")))
        return {"latency": merged, "outcomes": outcomes,
                "tenants": tenants, "slo_index": worst,
                "slo_state": (_SLO_STATE_ORDER[worst]
                              if 0 <= worst < len(_SLO_STATE_ORDER)
                              else "unknown")}

    def snapshot(self) -> dict:
        """The fleet view for CLIs and the CI gate: per-replica scrape
        records (ages recomputed now) plus the fleet rollup."""
        now = time.monotonic()
        with self._lock:
            records = [dict(r) for r in self._scrapes.values()]
        for r in records:
            last_ok = r.get("last_ok_monotonic")
            r["scrape_age_s"] = ((now - last_ok)
                                 if last_ok is not None else None)
            # tuple label keys -> "k=v,..." strings so the snapshot is
            # JSON-serializable (the CI gate writes it to a report file)
            for field in ("counters", "rates"):
                r[field] = {name: {_label_str(k): v
                                   for k, v in series.items()}
                            for name, series in (r.get(field)
                                                 or {}).items()}
        fleet = self._fleet_rollup(records)
        if fleet["latency"]:
            fleet["p50"] = fleet["latency"].get("p50")
            fleet["p99"] = fleet["latency"].get("p99")
        else:
            fleet["p50"] = fleet["p99"] = None
        return {"replicas": {r["replica_id"]: r for r in records},
                "fleet": fleet}


# ---------------------------------------------------------------------------
# families-dict extraction helpers (shared by json and prom modes)
# ---------------------------------------------------------------------------

def _label_key(labels: dict) -> Tuple:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _label_str(key: Tuple) -> str:
    return ",".join(f"{k}={v}" for k, v in key)


def _counter_values(families: dict) -> Dict[str, Dict[Tuple, float]]:
    out: Dict[str, Dict[Tuple, float]] = {}
    for name, fam in families.items():
        if not isinstance(fam, dict) or fam.get("kind") != "counter":
            continue
        series: Dict[Tuple, float] = {}
        for v in fam.get("values", ()):
            try:
                series[_label_key(v.get("labels") or {})] = \
                    float(v.get("value"))
            except (TypeError, ValueError, AttributeError):
                continue
        out[name] = series
    return out


def _outcome_counts(families: dict) -> Dict[str, float]:
    fam = families.get(OUTCOME_COUNTER) or {}
    out: Dict[str, float] = {}
    for v in fam.get("values", ()) if isinstance(fam, dict) else ():
        labels = v.get("labels") or {}
        key = labels.get("outcome")
        if key is None:
            continue
        try:
            out[key] = out.get(key, 0.0) + float(v.get("value"))
        except (TypeError, ValueError):
            continue
    return out


def _gauge_value(families: dict, name: str) -> Optional[float]:
    fam = families.get(name)
    if not isinstance(fam, dict):
        return None
    for v in fam.get("values", ()):
        if not (v.get("labels") or {}):
            try:
                return float(v.get("value"))
            except (TypeError, ValueError):
                return None
    return None


def _latency_snapshot(families: dict) -> Optional[dict]:
    """The (unlabeled) request-latency histogram snapshot, or None."""
    fam = families.get(REQUEST_LATENCY_METRIC)
    if not isinstance(fam, dict) or fam.get("kind") != "histogram":
        return None
    for v in fam.get("values", ()):
        if not (v.get("labels") or {}):
            snap = v.get("value")
            if isinstance(snap, dict) and isinstance(
                    snap.get("buckets"), dict):
                return snap
    return None


def _slo_index(slo: Optional[dict]) -> int:
    state = (slo or {}).get("state")
    try:
        return _SLO_STATE_ORDER.index(state)
    except ValueError:
        return -1


def _families_from_prom(parsed: dict) -> dict:
    """Reassemble ``parse_prometheus_text`` output into the JSON
    document's ``families`` shape, so the extraction helpers work on
    either scrape mode. Histogram label sets are regrouped (minus the
    parser's ``__series__``/``le`` bookkeeping labels) and rebuilt into
    snapshot dicts."""
    out: Dict[str, dict] = {}
    for name, fam in parsed.items():
        if fam.kind == "histogram":
            groups: Dict[Tuple, List] = {}
            for labels, v in fam.samples:
                base = {k: val for k, val in labels.items()
                        if k not in ("__series__", "le")}
                groups.setdefault(_label_key(base), []).append(
                    (labels, v))
            values = []
            for key, samples in groups.items():
                sub = _monitor.ParsedFamily(name)
                sub.samples = samples
                values.append({"labels": dict(key),
                               "value":
                               _monitor.histogram_snapshot_from_samples(
                                   sub)})
            out[name] = {"kind": "histogram", "help": fam.help or "",
                         "values": values}
        else:
            out[name] = {
                "kind": fam.kind or "gauge", "help": fam.help or "",
                "values": [{"labels": dict(labels), "value": v}
                           for labels, v in fam.samples]}
    return out
