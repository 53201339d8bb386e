"""The port's program, numerics and registry gates
(``tools/torch_lint_program.py``, ``tools/torch_lint_numerics.py``,
``tools/torch_audit_registry.py``) against the JAX package's CLIs on the
CPU: each exits 0 over the port's zoo, each negative control fails, and
over the same programs (each built under its own
``unique_name.guard()``) the port's findings, as ``(code, op_type)`` per
program, equal the JAX tools'. The JAX tools' sharding_check findings (PT730-PT744) are left
out: the port, which runs on one card, has no sharding analysis."""
import importlib.util
import json
import os

import pytest

from paddle_tpu.analysis import ALL_ANALYSIS_PASSES as J_PASSES
from paddle_tpu.analysis import default_pass_manager as j_manager
from paddle_tpu.analysis.numerics import analyze_numerics as j_numerics

import paddle_tpu_torch as fluid
from paddle_tpu_torch.analysis import ALL_ANALYSIS_PASSES as T_PASSES
from paddle_tpu_torch.analysis import default_pass_manager as t_manager
from paddle_tpu_torch.analysis.numerics import analyze_numerics as t_numerics
from tools import lint_numerics as JN
from tools import lint_program as JP
from tools import torch_audit_registry as TA
from tools import torch_lint_numerics as TN
from tools import torch_lint_program as TP


def _codes(diags):
    return sorted((d.code, d.op_type or "") for d in diags
                  if not "PT730" <= d.code <= "PT744")


def test_lint_program_zoo_is_clean(tmp_path, capsys):
    out = tmp_path / "lint.json"
    assert TP.main(["--zoo", "--json", str(out)]) == 0
    rep = json.loads(out.read_text())
    names = {p["name"] for p in rep["programs"]}
    assert {"zoo/mnist_mlp/main", "zoo/resnet18/main", "zoo/bert_tiny/main",
            "zoo/deepfm/main", "zoo/seq2seq/main", "zoo/gpt_tiny/prefill",
            "zoo/gpt_tiny/decode", "word2vec/main"} <= names
    assert rep["status"] == "ok"
    assert all(p["status"] == "ok" for p in rep["programs"])
    assert rep["pass_timings"]
    assert "[FAIL]" not in capsys.readouterr().out


def test_lint_program_findings_equal_the_jax_tools():
    jax_progs = JP._builtin_programs() + JP._zoo_programs()
    port_progs = TP._builtin_programs() + TP._zoo_programs()
    assert [p[0] for p in jax_progs] == [p[0] for p in port_progs]
    for (name, jprog, jfetch), (_, tprog, tfetch) in zip(jax_progs,
                                                         port_progs):
        j = j_manager().run_pipeline(jprog, J_PASSES, fetch_names=jfetch,
                                     verify="none").diagnostics
        t = t_manager().run_pipeline(tprog, T_PASSES, fetch_names=tfetch,
                                     verify="none").diagnostics
        assert _codes(t) == _codes(j), name
    # and the allowlist covers the same dead-code findings
    assert set(TP.ALLOWLIST) == {k for k in JP.ALLOWLIST
                                 if not "PT730" <= k[0] <= "PT744"}


def test_lint_program_fails_a_broken_program(tmp_path, capsys):
    """The negative control: a serialized program whose mul lost its
    required Y slot gates with an error (exit 1), and a file that does
    not parse is a lint failure too."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data("x", shape=[4], dtype="float32")
        fluid.layers.fc(x, 2)
    doc = json.loads(main.to_json())
    doc["blocks"][0]["ops"][0]["inputs"].pop("Y")
    broken = tmp_path / "broken.json"
    broken.write_text(json.dumps(doc))
    garbage = tmp_path / "garbage.json"
    garbage.write_text("{not json")
    out = tmp_path / "lint.json"
    assert TP.main([str(broken), str(garbage), "--json", str(out)]) == 1
    text = capsys.readouterr().out
    assert "[FAIL]" in text and "PT101" in text
    rep = json.loads(out.read_text())
    assert rep["status"] == "fail"
    assert [p["status"] for p in rep["programs"]] == ["fail", "fail"]


def test_lint_numerics_is_clean_with_qat_and_the_witness(tmp_path):
    out = tmp_path / "num.json"
    assert TN.main(["--witness", "--json", str(out)]) == 0
    rep = json.loads(out.read_text())
    names = [t["name"] for t in rep["targets"]]
    assert {"zoo/resnet18+qat", "zoo/bert_tiny+qat",
            "zoo/gpt_tiny/prefill+qat"} <= set(names)
    assert all(t["status"] == "ok" for t in rep["targets"])
    assert [w["name"] for w in rep["witness"]] == \
        [n for n, _ in TN.WITNESS_RUNS]
    for w in rep["witness"]:
        assert w["status"] == "ok" and w["violations"] == []
        assert w["checked_vars"], w["name"]


def test_lint_numerics_findings_equal_the_jax_tools():
    jax_targets = JN._zoo_targets()
    port_targets = TN._zoo_targets()
    assert [t[0] for t in jax_targets] == [t[0] for t in port_targets]
    for j, t in zip(jax_targets, port_targets):
        jr = j_numerics(j[1], fetch_names=j[3])
        tr = t_numerics(t[1], fetch_names=t[3])
        assert _codes(tr.diagnostics) == _codes(jr.diagnostics), t[0]
        assert len(tr.quant_sites) == len(jr.quant_sites), t[0]


def test_lint_numerics_negative_control_fails(capsys):
    assert TN.main(["--negative-control"]) == 1
    text = capsys.readouterr().out
    assert "-> FAIL" in text
    for code in TN.GATING_CODES:
        assert code in text


def test_numerics_fixtures_are_the_jax_packages_over_the_port():
    """Each port fixture is the JAX package's with the package name
    swapped, and trips the code it names in both packages."""
    here = os.path.dirname(os.path.abspath(__file__))
    fixtures = sorted(f for f in os.listdir(TN.FIXTURE_DIR)
                      if f.startswith("pt9"))
    assert len(fixtures) == len(TN.GATING_CODES)
    for mod in fixtures:
        with open(os.path.join(here, "fixtures", "numerics", mod)) as f:
            jax_src = f.read()
        with open(os.path.join(TN.FIXTURE_DIR, mod)) as f:
            port_src = f.read()
        assert port_src == jax_src.replace("paddle_tpu", "paddle_tpu_torch")
        for pkg_dir, analyze in (("numerics", j_numerics),
                                 ("torch_numerics", t_numerics)):
            spec = importlib.util.spec_from_file_location(
                f"_fx_{pkg_dir}_{mod[:-3]}",
                os.path.join(here, "fixtures", pkg_dir, mod))
            m = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(m)
            main, _, fetch = m.build()
            codes = {d.code for d in analyze(main,
                                             fetch_names=fetch).diagnostics}
            assert m.EXPECTED in codes, (pkg_dir, mod)


@pytest.mark.parametrize("strict", [False, True])
def test_audit_registry_exits_clean(tmp_path, capsys, strict):
    out = tmp_path / "audit.json"
    args = ["--json-file", str(out)] + (["--strict"] if strict else [])
    assert TA.main(args) == 0
    rep = json.loads(out.read_text())
    assert rep["missing_lower"] == [] and rep["status"] == "ok"
    assert rep["summary"]["ops"] == len(rep["ops"]) > 250
    assert "lower" in capsys.readouterr().out.splitlines()[0].lower()
