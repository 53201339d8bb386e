"""``tools/torch_chaos_check.py`` against the JAX package's
``tools/chaos_check.py`` on the CPU, with real process kills: the same
phase table (check names in order, all true), the same phase and result
keys (the port adds ``launches`` to each worker's result, and ``model``
and ``device`` to the report), the resumed run's loss and parameter
digest bit-equal to the port's own baseline; the JAX tool's
multi-device legs raise, naming the multi-device slice. The negative
control is in ``test_torch_chaos_bert.py``."""
import json
import os
import subprocess
import sys

import pytest

from tools import torch_chaos_check as TC

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# what the port's report adds to the JAX tool's
PORT_REPORT_KEYS = {"model", "device"}
PORT_RESULT_KEYS = {"launches"}


def test_phase_table_and_keys_equal_the_jax_tools(tmp_path, capsys):
    jax_json = tmp_path / "jax.json"
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    # the JAX gate's three workers run beside the port's
    jax_gate = subprocess.Popen(
        [sys.executable, os.path.join(REPO, "tools", "chaos_check.py"),
         "--check", "--workdir", str(tmp_path / "jax_work"),
         "--json", str(jax_json)], cwd=REPO, env=env,
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    port_json = tmp_path / "port.json"
    rc = TC.main(["--check", "--device", "cpu", "--workdir",
                  str(tmp_path / "port_work"), "--json", str(port_json)])
    assert jax_gate.wait(timeout=300) == 0
    assert rc == 0
    assert "chaos gate: 10/10 checks -> ok" in capsys.readouterr().out
    j, t = json.loads(jax_json.read_text()), json.loads(port_json.read_text())
    assert [(c["name"], c["ok"]) for c in t["checks"]] == \
        [(c["name"], c["ok"]) for c in j["checks"]]
    assert set(t) == set(j) | PORT_REPORT_KEYS
    assert t["mode"] == j["mode"] == "chaos" and t["status"] == "ok"
    assert set(t["phases"]) == set(j["phases"]) == {"baseline", "kill",
                                                    "resume"}
    assert set(t["phases"]["baseline"]) == \
        set(j["phases"]["baseline"]) | PORT_RESULT_KEYS
    assert set(t["phases"]["kill"]) == \
        set(j["phases"]["kill"]) | PORT_RESULT_KEYS
    assert set(t["phases"]["resume"]) == set(j["phases"]["resume"])
    assert set(t["phases"]["resume"]["result"]) == \
        set(j["phases"]["resume"]["result"]) | PORT_RESULT_KEYS
    base, res = t["phases"]["baseline"], t["phases"]["resume"]["result"]
    assert res["final_loss"] == base["final_loss"]
    assert res["params_sha256"] == base["params_sha256"]
    assert (res["start_step"], res["resumed_from_serial"]) == (5, 5)
    for key in ("start_step", "resumed_from_serial", "final_step",
                "retries", "giveups", "fallbacks"):
        assert res[key] == j["phases"]["resume"]["result"][key], key
    assert t["phases"]["kill"]["serials_after_kill"] == \
        j["phases"]["kill"]["serials_after_kill"] == [5]
    # the work dir is gone unless kept
    assert not (tmp_path / "port_work").exists()


@pytest.mark.parametrize("flag", ["--multichip", "--elastic"])
def test_multi_device_legs_raise_naming_queue_a_item_6(flag):
    with pytest.raises(NotImplementedError, match="Queue A item 6"):
        TC.main(["--check", flag])
