#!/usr/bin/env python
"""Convert the PyTorch port's profiler/trace dumps to ONE Chrome tracing
JSON (chrome://tracing / Perfetto); the counterpart of tools/timeline.py,
with its options, event schema and output.

Two host-side sources share one wall-clock anchor:

* ``host_events.json`` — the ``paddle_tpu_torch.profiler.profiler(
  profile_path=...)`` RecordEvent span dump (next to ``torch_trace.json``,
  the torch.profiler trace, which itself opens in Perfetto). Each span
  carries an ``epoch`` anchor recorded at ``__enter__`` (spans written
  without that field fall back to a relative timeline).
* a ``paddle_tpu_torch.trace`` span dump — JSONL from
  ``trace.export_jsonl`` (``--trace_path``). Spans carry ``t0_epoch``
  natively.

Both map onto the epoch clock, so a serving request's trace spans line up
against the executor's RecordEvent intervals in one merged timeline:
profiler rows under pid 0, trace spans under pid 1 (grouped per thread),
with trace/span ids in each event's ``args``.

Usage:
    python tools/torch_timeline.py --profile_path /tmp/profile \
                                   --timeline_path /tmp/timeline.json
    python tools/torch_timeline.py --trace_path spans.jsonl \
                                   --timeline_path /tmp/timeline.json
    python tools/torch_timeline.py --profile_path /tmp/profile \
                                   --trace_path spans.jsonl \
                                   --timeline_path /tmp/merged.json

It reads JSON files only: nothing of the framework is imported.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional


def _load_host_spans(profile_path: str) -> Optional[list]:
    src = profile_path
    if os.path.isdir(src):
        src = os.path.join(src, "host_events.json")
    if not os.path.exists(src):
        print(f"no host_events.json under {profile_path} — run under "
              f"paddle_tpu_torch.profiler.profiler(profile_path=...)",
              file=sys.stderr)
        return None
    with open(src) as f:
        return json.load(f)


def _load_trace_spans(trace_path: str) -> Optional[list]:
    if not os.path.exists(trace_path):
        print(f"no trace span dump at {trace_path} — write one with "
              f"paddle_tpu_torch.trace.export_jsonl(path)",
              file=sys.stderr)
        return None
    spans = []
    with open(trace_path) as f:
        for line in f:
            line = line.strip()
            if line:
                spans.append(json.loads(line))
    return spans


def convert(profile_path: Optional[str], timeline_path: str,
            trace_path: Optional[str] = None) -> int:
    host = _load_host_spans(profile_path) if profile_path else []
    if host is None:
        return 1
    tspans = _load_trace_spans(trace_path) if trace_path else []
    if tspans is None:
        return 1

    events: List[dict] = []
    # ---- profiler host events (pid 0) ---------------------------------
    # dumps without an 'epoch' field only carry perf_counter deltas; those
    # get a relative timeline — an empty profile is still a valid run, so
    # base defaults to 0.0
    have_epoch = bool(host) and all("epoch" in s for s in host)
    if have_epoch:
        def host_ts(s):
            return s["epoch"] * 1e6
    else:
        base = min((s["t0"] for s in host), default=0.0)

        def host_ts(s):
            return (s["t0"] - base) * 1e6
    for s in host:
        events.append({
            "name": s["name"],
            "ph": "X",
            "ts": host_ts(s),
            "dur": (s["t1"] - s["t0"]) * 1e6,
            "pid": 0,
            "tid": s.get("tid", 0),
            "cat": "host",
        })
    # ---- trace spans (pid 1), same epoch clock ------------------------
    # NOTE: this mapping mirrors paddle_tpu_torch.trace.to_chrome_events
    # over the to_dict() span shape — kept as a stdlib copy ON PURPOSE so
    # converting a JSON dump never imports the framework (and torch).
    # Change the event schema in BOTH places.
    if tspans and host and not have_epoch:
        print("warning: host_events.json has no epoch anchor — "
              "profiler rows are on a RELATIVE clock and will not line "
              "up with the trace spans", file=sys.stderr)
    for s in tspans:
        if s.get("duration_s") is None:
            continue
        args = {"trace_id": s.get("trace_id", ""),
                "span_id": s.get("span_id", ""),
                "status": s.get("status", "")}
        if s.get("parent_id"):
            args["parent_id"] = s["parent_id"]
        if s.get("error"):
            args["error"] = s["error"]
        args.update(s.get("attrs") or {})
        events.append({
            "name": s["name"],
            "ph": "X",
            "ts": s["t0_epoch"] * 1e6,
            "dur": s["duration_s"] * 1e6,
            "pid": 1,
            "tid": s.get("thread", 0),
            "cat": "trace",
            "args": args,
        })
    with open(timeline_path, "w") as f:
        json.dump({"traceEvents": events,
                   "displayTimeUnit": "ms"}, f)
    print(f"wrote {len(events)} events to {timeline_path} "
          f"({len(host)} profiler, "
          f"{len(events) - len(host)} trace)")
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--profile_path",
                    help="profiler dump dir (host_events.json)")
    ap.add_argument("--trace_path",
                    help="paddle_tpu_torch.trace JSONL span dump to merge")
    ap.add_argument("--timeline_path", required=True)
    args = ap.parse_args(argv)
    if not args.profile_path and not args.trace_path:
        ap.error("need --profile_path and/or --trace_path")
    return convert(args.profile_path, args.timeline_path,
                   trace_path=args.trace_path)


if __name__ == "__main__":
    sys.exit(main())
