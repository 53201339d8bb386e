"""``profiler`` in the PyTorch port (over ``torch.profiler``) against the
JAX package's, on the CPU.

* The same ``RecordEvent``s give the same report structure
  (``{"events": [{"name", "calls", "total_s", "avg_s"}], "sorted_by",
  "spans_path"}``), the same calls per event, each report ordered by its
  ``sorted_key``; the host aggregates count with no window open.
* ``RecordEvent`` is thread-safe against ``stop_profiler``
  (``tests/test_profiler_timeline.py``'s race, threads joined with a
  timeout).
* ``tools/timeline.py`` reads the port's ``host_events.json`` unchanged:
  nested spans nest on one row.
* A CPU ``torch.profiler`` trace is written (``torch_trace.json``) and
  holds the ``RecordEvent`` ranges of the thread that opened the window;
  the DataLoader's worker marks its reads and stagings in the host
  dump."""
import json
import logging
import os
import threading
import time

import numpy as np
import pytest

from paddle_tpu import profiler as jprof

import paddle_tpu_torch as tfluid
from paddle_tpu_torch import profiler as tprof
import tools.timeline as timeline

JOIN_S = 10.0
PROFS = {"jax": jprof, "torch": tprof}


@pytest.fixture(autouse=True)
def _clean():
    for p in PROFS.values():
        p.reset_profiler()
    yield
    for p in PROFS.values():
        p.reset_profiler()


def _events(p):
    for i in range(3):
        with p.RecordEvent("outer"):
            with p.RecordEvent("inner"):
                time.sleep(0.002 * (i + 1))
    with p.RecordEvent("once"):
        time.sleep(0.02)


@pytest.mark.parametrize("key", [None, "total", "calls", "ave"])
def test_report_structure_matches_the_jax_package(tmp_path, key):
    reports = {}
    for k, p in PROFS.items():
        p.start_profiler(state="CPU", profile_path=str(tmp_path / k))
        _events(p)
        reports[k] = p.stop_profiler(sorted_key=key)
    j, t = reports["jax"], reports["torch"]
    assert t.keys() == j.keys() == {"events", "sorted_by", "spans_path"}
    assert t["sorted_by"] == j["sorted_by"] == (key or "total")
    # the same events and calls; each report in its key's order (the
    # times are each package's own, so equal times may not be)
    assert sorted((r["name"], r["calls"]) for r in t["events"]) == \
        sorted((r["name"], r["calls"]) for r in j["events"]) == \
        [("inner", 3), ("once", 1), ("outer", 3)]
    field = {"total": "total_s", "calls": "calls", "ave": "avg_s"}[
        key or "total"]
    for rep in (t, j):
        got = [r[field] for r in rep["events"]]
        assert got == sorted(got, reverse=True)
    for r in t["events"]:
        assert r.keys() == {"name", "calls", "total_s", "avg_s"}
        assert r["avg_s"] == pytest.approx(r["total_s"] / r["calls"])
    assert os.path.basename(t["spans_path"]) == "host_events.json"
    jspans = json.load(open(j["spans_path"]))
    tspans = json.load(open(t["spans_path"]))
    assert [s["name"] for s in tspans] == [s["name"] for s in jspans]
    assert [sorted(s) for s in tspans] == [sorted(s) for s in jspans]


def test_host_aggregates_count_without_a_window():
    for p in PROFS.values():
        with p.RecordEvent("agg"):
            time.sleep(0.01)
        with p.RecordEvent("agg"):
            pass
    assert tprof._host_events["agg"][0] == jprof._host_events["agg"][0] == 2
    assert tprof._host_events["agg"][1] >= 0.01


def test_stop_profiler_logs_and_prints(tmp_path, caplog, capsys):
    with caplog.at_level(logging.INFO, logger="paddle_tpu_torch.profiler"):
        tprof.start_profiler(profile_path=str(tmp_path))
        with tprof.RecordEvent("structured_event"):
            time.sleep(0.001)
        report = tprof.stop_profiler(sorted_key="calls")
    assert any("host event report" in r.message for r in caplog.records)
    assert "structured_event" in capsys.readouterr().out
    assert report["events"][0]["name"] == "structured_event"


def test_record_event_threadsafe_against_stop(tmp_path):
    stop = threading.Event()

    def worker():
        while not stop.is_set():
            with tprof.RecordEvent("worker_span"):
                pass

    threads = [threading.Thread(target=worker, daemon=True)
               for _ in range(4)]
    tprof.start_profiler(state="CPU", profile_path=str(tmp_path))
    for t in threads:
        t.start()
    try:
        time.sleep(0.05)
        report = tprof.stop_profiler()
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=JOIN_S)
    assert not any(t.is_alive() for t in threads)
    assert "worker_span" in [r["name"] for r in report["events"]]
    spans = json.load(open(report["spans_path"]))
    assert spans
    for s in spans:
        assert s["t1"] >= s["t0"] and isinstance(s["tid"], int)


def test_timeline_reads_the_port_dump(tmp_path):
    with tprof.profiler(state="CPU", profile_path=str(tmp_path)):
        with tprof.RecordEvent("span_outer"):
            with tprof.RecordEvent("span_inner"):
                time.sleep(0.002)
    out = tmp_path / "timeline.json"
    assert timeline.convert(str(tmp_path), str(out)) == 0
    assert timeline.main(["--profile_path", str(tmp_path),
                          "--timeline_path", str(out)]) == 0
    events = json.loads(out.read_text())["traceEvents"]
    outer = next(e for e in events if e["name"] == "span_outer")
    inner = next(e for e in events if e["name"] == "span_inner")
    assert outer["tid"] == inner["tid"]
    assert outer["ts"] <= inner["ts"]
    assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"] + 1e-3


def test_a_cpu_torch_profiler_trace_is_written(tmp_path):
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        x = tfluid.layers.data("x", shape=[4], dtype="float32")
        y = tfluid.layers.fc(x, 3)
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    loader = tfluid.DataLoader.from_generator(feed_list=[x], capacity=2)
    loader.set_batch_generator(
        lambda: iter([(np.ones((2, 4), np.float32),)] * 3),
        places=tfluid.CPUPlace())
    with tprof.profiler(state="All", profile_path=str(tmp_path)):
        with tprof.RecordEvent("user_step"):
            for b in loader:
                exe.run(main, feed=b, fetch_list=[y], scope=scope)
    path = tmp_path / tprof.TRACE_NAME
    assert path.exists()
    names = {e.get("name") for e in json.loads(path.read_text())[
        "traceEvents"]}
    assert "user_step" in names
    assert "aten::addmm" in names or "aten::mm" in names
    # the worker thread's events land in the host dump (torch.profiler
    # records the ranges of the thread that opened the window)
    spans = {s["name"] for s in json.load(open(tmp_path /
                                               "host_events.json"))}
    assert {"user_step", "dataloader::read", "dataloader::stage"} <= spans
    calls = {r["name"]: r["calls"] for r in
             tprof._host_report({k: tuple(v) for k, v in
                                 tprof._host_events.items()})["events"]}
    assert calls["dataloader::stage"] == 3
    assert calls["dataloader::read"] == 4     # three batches and the end


def test_cuda_and_npu_profiler_are_context_managers():
    with tprof.cuda_profiler("unused", "csv"):
        pass
    with tprof.npu_profiler():
        pass
