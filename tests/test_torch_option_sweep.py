"""``tools/torch_option_sweep.py`` against the JAX package's
``tools/xla_sweep.py`` on the CPU: the ranked artifact has the JAX tool's
keys (report, model and trial level) and ranks; the port's option sets
are its tunables (K5's compiled tilings, the conv layout, the epilogue
fusion); with ``FLAGS_autotune=measure`` the tiling trials reach the
tuning database; a sweep of sets that cannot run fails to rank (the
negative control)."""
import json

import pytest

import paddle_tpu_torch as tfluid
from paddle_tpu_torch import tuning
from tools import torch_gate_probes as probes
from tools import torch_option_sweep as TS
from tools import xla_sweep as JS


@pytest.fixture(autouse=True)
def _cpu():
    probes.set_device("cpu")
    yield
    probes.set_device("cuda")


def test_option_sets_are_the_ports_tunables():
    sets = TS.default_option_sets()
    assert sets[0] == {}
    tilings = [s["FLAGS_fused_gemm_blocks"] for s in sets
               if "FLAGS_fused_gemm_blocks" in s]
    assert tilings == [",".join(map(str, c.gemm_blocks))
                       for c in tuning.default_candidates(True)[1:]]
    assert {"FLAGS_conv_use_nhwc": "always"} in sets
    assert {"FLAGS_conv_use_nhwc": "never"} in sets
    assert {"FLAGS_epilogue_fusion": False} in sets


def test_artifact_has_the_jax_tools_keys_and_ranks(tmp_path, capsys):
    jrep = JS.sweep(["mlp"], [{}], True, 2, 3, 1)
    out = tmp_path / "sweep.json"
    assert TS.main(["--ci", "--device", "cpu", "--model", "mlp",
                    "--json", str(out)]) == 0
    assert "sweep gate -> ok" in capsys.readouterr().out
    trep = json.loads(out.read_text())
    assert set(trep) == set(jrep)
    assert trep["backend"] == "cpu" and trep["autotune_db"] is None
    assert trep["protocol"] == "run_chained differencing: (T(6)-T(2))/4, " \
                               "min over 1 repeats"
    (jm,), (tm,) = jrep["models"].values(), trep["models"].values()
    assert set(tm) == set(jm)
    jt = jm["trials"][0]
    assert all(set(t) == set(jt) for t in tm["trials"])
    assert [t["options"] for t in tm["trials"]] == TS.default_option_sets()
    ranks = sorted(t["rank"] for t in tm["trials"])
    assert ranks == list(range(len(tm["trials"])))
    best = min(tm["trials"], key=lambda t: t["per_step_s"])
    assert tm["best_options"] == best["options"] and best["rank"] == 0
    assert tm["best_per_step_s"] == best["per_step_s"]


def test_measure_mode_records_the_tiling_trials(tmp_path, monkeypatch):
    db = tmp_path / "tune.json"
    tuning.reset_database_cache()
    prev = tfluid.get_flags(["FLAGS_autotune", "FLAGS_autotune_db"])
    tfluid.set_flags({"FLAGS_autotune": "measure",
                      "FLAGS_autotune_db": str(db)})
    try:
        sets = [{}, {"FLAGS_fused_gemm_blocks": "64,64,32"},
                {"FLAGS_conv_use_nhwc": "never"}]
        rep = TS.sweep(["mlp"], sets, True, 2, 3, 1)
    finally:
        tfluid.set_flags(prev)
        tuning.reset_database_cache()
    assert rep["autotune_db"] == str(db)
    assert all(t["status"] == "ok" for t in rep["models"]["mlp"]["trials"])
    trials = [t for e in json.loads(db.read_text())["entries"].values()
              for t in e["trials"]]
    # the baseline and the tiling; the layout set is reported, not kept
    assert sorted(str(t["candidate"]["gemm_blocks"]) for t in trials) == \
        ["None", "[64, 64, 32]"]


def test_sets_that_cannot_run_fail_to_rank(tmp_path, capsys):
    out = tmp_path / "neg.json"
    assert TS.main(["--ci", "--device", "cpu", "--model", "mlp",
                    "--negative-control", "--json", str(out)]) == 1
    assert "-> FAIL" in capsys.readouterr().err
    rep = json.loads(out.read_text())
    trials = rep["models"]["mlp"]["trials"]
    assert [t["status"] for t in trials] == ["error", "error"]
    assert rep["models"]["mlp"]["best_options"] is None
