"""``tools/torch_mem_report.py`` against the JAX package's
``tools/mem_report.py`` on the CPU: over the book programs and the lint
builtin suite, the same program names, per-program peak bytes and plan
keys and the same PT5xx findings; a program with an error-severity PT5xx
finding fails the gate; the JAX tool's per-chip modes raise, naming the
multi-device slice."""
import json

import pytest

from tools import mem_report as JM
from tools import torch_mem_report as TM


def _findings(entry):
    return sorted((d["code"], d["severity"], d["op_type"] or "")
                  for d in entry["diagnostics"])


def test_book_programs_plan_as_the_jax_tool(tmp_path, capsys):
    jout, tout = tmp_path / "jax.json", tmp_path / "port.json"
    assert JM.main(["--check", "--json", str(jout)]) == 0
    assert TM.main(["--check", "--json", str(tout)]) == 0
    assert "memory gate -> ok" in capsys.readouterr().out
    jrep, trep = json.loads(jout.read_text()), json.loads(tout.read_text())
    assert trep["batch_size"] == jrep["batch_size"] == 64
    assert [p["name"] for p in trep["programs"]] == \
        [p["name"] for p in jrep["programs"]]
    assert len(trep["programs"]) == 11
    for t, j in zip(trep["programs"], jrep["programs"]):
        assert set(t) == set(j), t["name"]
        assert set(t["plan"]) == set(j["plan"]), t["name"]
        assert t["plan"]["peak_bytes"] == j["plan"]["peak_bytes"], t["name"]
        assert t["plan"]["peak_op_idx"] == j["plan"]["peak_op_idx"], \
            t["name"]
        assert t["feeds"] == j["feeds"] and t["fetches"] == j["fetches"]
        assert _findings(t) == _findings(j), t["name"]


def _pt504_program():
    """A persistable rebound inside a sub-block whose owning op does not
    list it: the write is lost (PT504, error severity)."""
    import paddle_tpu_torch as fluid
    import paddle_tpu_torch.unique_name as un

    with un.guard():
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            blk = main.global_block
            blk.create_var(name="stat", shape=[1], dtype="float32",
                           persistable=True)
            cv = fluid.layers.fill_constant([1], "bool", True)
            sub = main._create_block()
            sub.append_op("fill_constant", outputs={"Out": ["stat"]},
                          attrs={"shape": [1], "dtype": "float32",
                                 "value": 1.0})
            main._rollback()
            blk.append_op("conditional_block",
                          inputs={"Cond": [cv.name], "Input": []},
                          outputs={"Out": []}, attrs={"sub_block": sub.idx})
    return main


def test_an_error_finding_fails_the_gate(tmp_path, capsys):
    path = tmp_path / "pt504.json"
    path.write_text(_pt504_program().to_json())
    out = tmp_path / "report.json"
    assert TM.main([str(path), "--check", "--json", str(out)]) == 1
    text = capsys.readouterr().out
    assert f"[FAIL] {path}" in text and "memory gate -> FAIL" in text
    entry = json.loads(out.read_text())["programs"][0]
    assert [d["code"] for d in entry["diagnostics"]
            if d["severity"] == "error"] == ["PT504"]


@pytest.mark.parametrize("argv", [["--mesh", "dp=8"],
                                  ["--specs", "zero1"],
                                  ["--mesh", "dp=8", "--validate-live"],
                                  ["--validate-live"],
                                  ["--hbm-budget-mb", "15872"]])
def test_multi_device_modes_raise_naming_queue_a_item_6(argv):
    with pytest.raises(NotImplementedError, match="Queue A item 6"):
        TM.main(argv)
