"""``tools/torch_timeline.py`` on the port's own dumps: the profiler's
``host_events.json`` and a ``trace.export_jsonl`` span dump merge into one
Chrome trace whose events are the two inputs' (profiler rows under pid 0,
spans under pid 1, both on the epoch clock), and the JAX package's
``tools/timeline.py`` writes the same file from the same inputs."""
import json

import numpy as np
import pytest

import paddle_tpu_torch as fluid
import paddle_tpu_torch.unique_name as un
from paddle_tpu_torch import trace
from tools import timeline as JT
from tools import torch_timeline as TT


@pytest.fixture
def dumps(tmp_path):
    """A profiled, traced run of a small program: (profile dir, span
    dump path, host rows, finished spans)."""
    prof = tmp_path / "prof"
    with un.guard():
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            x = fluid.layers.data("x", shape=[4], dtype="float32")
            y = fluid.layers.fc(x, 3, act="relu")
    exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    exe.run(startup, scope=scope)
    prev = fluid.get_flags(["FLAGS_trace"])
    fluid.set_flags({"FLAGS_trace": 1})
    trace.clear()
    try:
        with fluid.profiler.profiler(profile_path=str(prof)):
            with trace.root_span("timeline.request", rows=2):
                with trace.span("timeline.step"), \
                        fluid.profiler.RecordEvent("timeline::run"):
                    exe.run(main, feed={"x": np.ones((2, 4), np.float32)},
                            fetch_list=[y], scope=scope)
                with fluid.profiler.RecordEvent("timeline::after"):
                    pass
        spans_path = tmp_path / "spans.jsonl"
        trace.export_jsonl(str(spans_path))
    finally:
        fluid.set_flags(prev)
        trace.clear()
    host = json.loads((prof / "host_events.json").read_text())
    spans = [json.loads(line) for line in spans_path.read_text().splitlines()
             if line.strip()]
    return prof, spans_path, host, spans


def test_merged_events_are_the_two_inputs(dumps, tmp_path, capsys):
    prof, spans_path, host, spans = dumps
    out = tmp_path / "merged.json"
    assert TT.main(["--profile_path", str(prof), "--trace_path",
                    str(spans_path), "--timeline_path", str(out)]) == 0
    doc = json.loads(out.read_text())
    assert doc["displayTimeUnit"] == "ms"
    events = doc["traceEvents"]
    finished = [s for s in spans if s.get("duration_s") is not None]
    assert host and finished
    assert len(events) == len(host) + len(finished)
    rows = [e for e in events if e["pid"] == 0]
    assert [(e["name"], e["ts"], e["dur"]) for e in rows] == [
        (h["name"], h["epoch"] * 1e6, (h["t1"] - h["t0"]) * 1e6)
        for h in host]
    assert [e["name"] for e in rows] == ["timeline::run", "timeline::after"]
    traced = [e for e in events if e["pid"] == 1]
    assert [(e["name"], e["ts"], e["args"]["span_id"]) for e in traced] == [
        (s["name"], s["t0_epoch"] * 1e6, s["span_id"]) for s in finished]
    assert {"timeline.request", "timeline.step"} <= {e["name"]
                                                     for e in traced}
    root = next(e for e in traced if e["name"] == "timeline.request")
    assert root["args"]["rows"] == 2
    assert f"{len(events)} events" in capsys.readouterr().out


def test_the_jax_tool_writes_the_same_file(dumps, tmp_path):
    prof, spans_path, _, _ = dumps
    mine, theirs = tmp_path / "port.json", tmp_path / "jax.json"
    assert TT.convert(str(prof), str(mine), trace_path=str(spans_path)) == 0
    assert JT.convert(str(prof), str(theirs),
                      trace_path=str(spans_path)) == 0
    assert json.loads(mine.read_text()) == json.loads(theirs.read_text())


def test_missing_inputs_fail(tmp_path):
    assert TT.convert(str(tmp_path / "none"),
                      str(tmp_path / "out.json")) == 1
    assert TT.convert(None, str(tmp_path / "out.json"),
                      trace_path=str(tmp_path / "none.jsonl")) == 1
    with pytest.raises(SystemExit):
        TT.main(["--timeline_path", str(tmp_path / "out.json")])
