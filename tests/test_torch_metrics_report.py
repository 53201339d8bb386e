"""``tools/torch_metrics_report.py`` against the JAX package's
``tools/metrics_report.py`` on the CPU: the same scenarios with the same
per-scenario compile, cache-lookup, chained-iteration and recompile
counts (the port's compile event is the first run of an executor key);
the forced-recompile negative control trips the gate in both; the
full-width scenarios rehearsed at BERT-tiny width.

One deliberate difference: the JAX executor keeps a fetched parameter
donation-unsafe (``kept_buffers`` > 0 in ``chained_kept_state``); the port
updates state in place and copies the fetched value, so it keeps none."""
import json

import pytest

from tools import metrics_report as JMR
from tools import torch_gate_probes as probes
from tools import torch_metrics_report as TMR

# the counts the two executors must agree on
COUNTS = ("run_compiles", "run_hits", "run_misses", "chained_compiles",
          "chained_hits", "chained_misses", "chained_iterations",
          "recompiles")


@pytest.fixture(autouse=True)
def _cpu():
    probes.set_device("cpu")
    yield
    probes.set_device("cuda")


def _by_name(report):
    return {s["name"]: s for s in report["scenarios"]}


def test_scenarios_count_as_the_jax_tools(tmp_path, capsys):
    jout, tout = tmp_path / "jax.json", tmp_path / "port.json"
    assert JMR.main(["--check", "--json", str(jout)]) == 0
    assert TMR.main(["--check", "--device", "cpu",
                     "--json", str(tout)]) == 0
    jrep = json.loads(jout.read_text())
    trep = json.loads(tout.read_text())
    jsc, tsc = _by_name(jrep), _by_name(trep)
    assert list(tsc) == list(jsc) == ["run_repeat", "chained_kept_state",
                                      "infer_clone_repeat"]
    for name, t in tsc.items():
        j = jsc[name]
        assert set(t) == set(j), name
        assert {k: t["metrics"][k] for k in COUNTS} == \
            {k: j["metrics"][k] for k in COUNTS}, name
        assert t["expect"] == j["expect"] and t["ok"] and j["ok"], name
    kept = tsc["chained_kept_state"]["metrics"]
    assert kept["donated_buffers"] > 0 and kept["kept_buffers"] == 0
    assert set(trep["check"]) == set(jrep["check"])
    assert trep["check"]["status"] == jrep["check"]["status"] == "ok"
    assert set(trep) == set(jrep) == {"scenarios", "snapshot", "check"}


def test_forced_recompiles_trip_the_gate_as_in_the_jax_tool(tmp_path,
                                                            capsys):
    jout, tout = tmp_path / "jax.json", tmp_path / "port.json"
    assert JMR.main(["--check", "--force-recompile", "3",
                     "--json", str(jout)]) == 1
    capsys.readouterr()
    assert TMR.main(["--check", "--device", "cpu", "--force-recompile",
                     "3", "--json", str(tout)]) == 1
    assert "(threshold 0) -> FAIL" in capsys.readouterr().out
    j = _by_name(json.loads(jout.read_text()))["forced_recompile_x3"]
    t = _by_name(json.loads(tout.read_text()))["forced_recompile_x3"]
    assert {k: t["metrics"][k] for k in COUNTS} == \
        {k: j["metrics"][k] for k in COUNTS}
    assert t["metrics"]["recompiles"] == 3
    assert t["diagnostic"]["changed"] == j["diagnostic"]["changed"] == \
        ["feed_signature"]
    # a threshold that admits them passes
    assert TMR.main(["--check", "--device", "cpu", "--force-recompile",
                     "3", "--recompile-threshold", "3"]) == 0


def test_full_width_scenarios_rehearsed_at_bert_tiny_width():
    results, check = TMR.run_suite("bert_base", tiny=True)
    assert [r["name"] for r in results] == [
        "run_repeat", "chained_kept_state", "infer_clone_repeat"]
    assert all(r["ok"] for r in results), [r["missed"] for r in results]
    assert check["status"] == "ok" and check["recompiles"] == 0
    chained = results[1]["metrics"]
    assert chained["chained_iterations"] == 2 * TMR.CHAINED_STEPS
