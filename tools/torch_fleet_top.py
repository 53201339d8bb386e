#!/usr/bin/env python
"""fleet_top — a one-shot / ``--watch`` fleet telemetry viewer for the
PyTorch port's fleet (counterpart of tools/fleet_top.py, same table).

Scrapes every named replica's ``/metrics.json`` through a
:class:`paddle_tpu_torch.serving.fleet.FleetAggregator` and renders the
aggregator snapshot as a terminal table: per-replica pressure (up /
stale / scrape age / queue depth / request rate / p50 / p99 / SLO burn
state), the EXACT cross-replica latency merge as the fleet p50/p99, the
autoscaler's status when an embedding process passes one, and the
busiest tenants by engine occupancy. Point it at any running fleet:

  python tools/torch_fleet_top.py r0=127.0.0.1:8000 r1=127.0.0.1:8001
  python tools/torch_fleet_top.py --watch --interval 2 r0=127.0.0.1:8000

A replica that stops answering (or answers garbage) shows up stale with
its typed error and a growing age — exactly the degraded view the
aggregator publishes, never a crash.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import paddle_tpu_torch as fluid  # noqa: E402
from paddle_tpu_torch.serving.fleet import (  # noqa: E402
    AggregatorConfig, FleetAggregator)


def _fmt_ms(v) -> str:
    return f"{v * 1e3:8.1f}" if v is not None else f"{'-':>8}"


def _fmt(v, spec="8.1f") -> str:
    return f"{v:{spec}}" if v is not None else f"{'-':>{spec.split('.')[0]}}"


def _completed_rate(rec) -> float | None:
    rates = (rec.get("rates") or {}).get("serving_requests_total") or {}
    return rates.get("outcome=completed")


_BURN_ORDER = {"ok": 0, "warning": 1, "burning": 2}


def _class_burn(replicas: dict) -> dict:
    """Worst per-class SLO burn state across every scraped replica."""
    classes: dict = {}
    for rec in replicas.values():
        for name, cls in ((rec.get("slo") or {}).get("classes")
                          or {}).items():
            state = cls.get("state", "unknown")
            if _BURN_ORDER.get(state, -1) >= _BURN_ORDER.get(
                    classes.get(name), -1):
                classes[name] = state
    return classes


def render(snapshot: dict, clock: str, autoscaler: dict = None) -> str:
    """``autoscaler`` (optional) is a ``FleetAutoscaler.status()`` dict
    from an embedding process (the supervisor side); the scrape-only CLI
    renders everything else without it."""
    replicas = snapshot["replicas"]
    fleet = snapshot["fleet"]
    up = sum(1 for r in replicas.values() if r.get("up"))
    out = [f"fleet view @ {clock} — {len(replicas)} replicas, {up} up",
           f"{'REPLICA':10} {'UP':>3} {'STALE':>5} {'AGE_S':>6} "
           f"{'QUEUE':>5} {'REQ/S':>8} {'P50_MS':>8} {'P99_MS':>8} "
           f"{'SLO':>8}  ERR"]
    for rid in sorted(replicas):
        rec = replicas[rid]
        lat = rec.get("latency") or {}
        slo = (rec.get("slo") or {}).get("state", "unknown")
        out.append(
            f"{rid:10} {('yes' if rec.get('up') else 'no'):>3} "
            f"{('yes' if rec.get('stale') else 'no'):>5} "
            f"{_fmt(rec.get('scrape_age_s'), '6.1f')} "
            f"{_fmt(rec.get('queue_depth'), '5.0f')} "
            f"{_fmt(_completed_rate(rec), '8.2f')} "
            f"{_fmt_ms(lat.get('p50'))} {_fmt_ms(lat.get('p99'))} "
            f"{slo:>8}  {rec.get('error') or ''}")
    done = fleet["outcomes"].get("completed")
    out.append(
        f"fleet: p50 {_fmt_ms(fleet['p50']).strip()}ms  "
        f"p99 {_fmt_ms(fleet['p99']).strip()}ms  "
        f"completed {int(done) if done is not None else '-'}  "
        f"slo {fleet['slo_state']}")
    burn = _class_burn(replicas)
    if burn:
        out.append("slo burn: " + "  ".join(
            f"{name}={burn[name]}" for name in sorted(burn)))
    if autoscaler:
        sense = autoscaler.get("sense") or {}
        last = autoscaler.get("last_decision")
        decision = (f"{last['action']} ({last['reason']}) — "
                    f"{last['detail']}" if last else "none yet")
        out.append(
            f"autoscaler: replicas {sense.get('replicas', '-')} "
            f"(spawning {sense.get('spawning', 0)}, draining "
            f"{len(sense.get('draining') or [])})  "
            f"{'HOT' if sense.get('hot') else 'calm'}  "
            f"last: {decision}")
    tenants = sorted(fleet["tenants"].items(),
                     key=lambda kv: -kv[1]["occupancy_s"])
    if tenants:
        out.append(f"{'TENANT':12} {'REQS':>6} {'COMPLETED':>9} "
                   f"{'SHED':>6} {'QUOTA_SHED':>10} {'OCC_S':>8}")
        for name, t in tenants[:8]:
            outcomes = t.get("outcomes") or {}
            out.append(
                f"{name:12} {sum(outcomes.values()):>6} "
                f"{outcomes.get('completed', 0):>9} "
                f"{outcomes.get('shed', 0):>6} "
                f"{t.get('quota_sheds', 0):>10} "
                f"{t['occupancy_s']:>8.2f}")
    return "\n".join(out)


def parse_targets(specs) -> list:
    targets = []
    for spec in specs:
        rid, sep, addr = spec.partition("=")
        if not sep or ":" not in addr:
            raise SystemExit(f"bad target {spec!r} "
                             f"(want replica_id=host:port)")
        targets.append((rid, addr))
    return targets


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("targets", nargs="+",
                    metavar="replica_id=host:port",
                    help="replicas to scrape")
    ap.add_argument("--watch", action="store_true",
                    help="refresh continuously instead of one shot")
    ap.add_argument("--interval", type=float, default=2.0,
                    help="--watch refresh seconds (default 2)")
    ap.add_argument("--timeout", type=float, default=2.0,
                    help="per-scrape timeout seconds")
    args = ap.parse_args(argv)

    # the viewer IS the telemetry plane's consumer: turn it on locally
    # (the scraped replicas carry their own flag)
    fluid.set_flags({"FLAGS_fleet_telemetry": 1})
    agg = FleetAggregator(
        parse_targets(args.targets),
        AggregatorConfig(scrape_interval_s=max(args.interval, 0.1),
                         scrape_timeout_s=args.timeout))
    try:
        while True:
            agg.poll_now()
            clock = time.strftime("%H:%M:%S")
            text = render(agg.snapshot(), clock)
            if args.watch:
                sys.stdout.write("\x1b[2J\x1b[H" + text + "\n")
                sys.stdout.flush()
                time.sleep(max(args.interval, 0.1))
            else:
                print(text)
                return 0
    except KeyboardInterrupt:
        return 0


if __name__ == "__main__":
    sys.exit(main())
