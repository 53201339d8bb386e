"""``tools/torch_trace_check.py`` against the JAX package's
``tools/trace_check.py`` on the CPU: the cost-model leg gives the JAX
tool's FLOP counts and ratios on ResNet-50 and BERT-base; every leg's
structural checks hold (the JAX tool's leg names and check keys); the
flight recorder off (the negative control) fails the gate by its flight
legs; the full-width legs rehearsed at BERT-tiny width with the burst's
merged timeline."""
import json
import tempfile

import pytest

from tools import torch_gate_probes as probes
from tools import torch_trace_check as TT
from tools import trace_check as JT


@pytest.fixture(autouse=True)
def _cpu():
    probes.set_device("cpu")
    yield
    probes.set_device("cuda")


def test_cost_model_equals_the_jax_tools():
    j, t = JT.leg_cost_model(), TT.leg_cost_model()
    assert t["results"] == j["results"]
    assert t["checks"] == j["checks"] and all(t["checks"].values())


def test_every_leg_holds_with_the_jax_tools_checks(tmp_path, capsys):
    out = tmp_path / "trace.json"
    assert TT.main(["--check", "--device", "cpu", "--tmp", str(tmp_path),
                    "--json", str(out)]) == 0
    assert "-> ok" in capsys.readouterr().out
    rep = json.loads(out.read_text())
    assert set(rep) == {"legs", "mfu_figures", "incidents", "check"}
    names = [leg["name"] for leg in rep["legs"]]
    assert names == ["serving_burst", "trainer_steps", "batch_fault_flight",
                     "watchdog_flight", "cost_model", "overhead_guard"]
    for leg in rep["legs"]:
        assert leg["ok"] and all(leg["checks"].values()), leg["name"]
    # the JAX tool's check keys, leg by leg
    want = {
        "serving_burst": {"all_submitted", "one_trace_per_request",
                          "every_trace_complete", "chain_depth",
                          "cross_thread_parentage",
                          "accounting_carries_trace_ids",
                          "exact_accounting"},
        "trainer_steps": {"step_traces", "every_trace_complete",
                          "data_and_dispatch_children",
                          "checkpoint_span_present"},
        "batch_fault_flight": {"batch_failed_typed",
                               "error_carries_trace_id",
                               "incident_recorded", "full_chain_in_dump",
                               "batch_span_in_dump",
                               "typed_outcome_in_dump"},
        "watchdog_flight": {"watchdog_fired", "hang_failed_typed",
                            "watchdog_incident_recorded",
                            "expiry_dump_has_request_context",
                            "terminal_dump_full_chain"},
        "overhead_guard": {"no_allocation_when_disabled",
                           "disabled_under_budget"},
    }
    for leg in rep["legs"]:
        if leg["name"] in want:
            assert set(leg["checks"]) == want[leg["name"]], leg["name"]
    assert rep["mfu_figures"]["executor_mfu"]
    assert rep["mfu_figures"]["serving_bucket_mfu"]


def test_flight_recorder_off_fails_the_gate(tmp_path, capsys):
    assert TT.main(["--check", "--device", "cpu", "--tmp", str(tmp_path),
                    "--negative-control"]) == 1
    text = capsys.readouterr().out
    assert "-> FAIL" in text
    assert "[MISS] batch_fault_flight" in text
    assert "[MISS] watchdog_flight" in text
    assert "[ok] serving_burst" in text


def test_full_width_legs_rehearsed_at_bert_tiny_width(tmp_path):
    timeline = tmp_path / "timeline.json"
    legs, mfu = TT.run_legs(tempfile.mkdtemp(dir=tmp_path),
                            model="bert_base", tiny=True,
                            timeline=str(timeline))
    for leg in legs:
        assert leg["ok"], (leg["name"], leg["checks"])
    events = json.loads(timeline.read_text())["traceEvents"]
    assert legs[0]["timeline"]["events"] == len(events)
    assert {e["pid"] for e in events} == {0, 1}
    assert sum(e["name"] == "trace_check::submit" for e in events) == 24
    assert any(e["name"] == "serving.request" for e in events)
    assert any(e["labels"].get("bucket", "").startswith("b")
               for e in mfu["serving_bucket_mfu"])
