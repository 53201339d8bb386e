"""The card's chaos leg (``tools/torch_chaos_check.py --model bert_base``)
rehearsed on the CPU at BERT-tiny width: BERT f32 (batch 8, seq 128,
dropout 0, Adam) 8 steps with a checkpoint every 2, the kill inside
serial 4's write, the resume from serial 2 under two compile faults, and
the resumed run's loss and parameter digest bit-equal to the baseline's.
The CPU workers run one thread: the CPU's accumulating ``index_put_``
(the embedding gradients) adds with atomics across threads. And the
negative control: the resume with retries off under a persistent compile
fault fails the gate."""
import json

from tools import torch_chaos_check as TC


def test_bert_worker_resumes_bit_for_bit(tmp_path, capsys):
    out = tmp_path / "chaos.json"
    assert TC.main(["--check", "--device", "cpu", "--model", "bert_base",
                    "--tiny", "--workdir", str(tmp_path / "w"),
                    "--keep-workdir", "--json", str(out)]) == 0
    assert "chaos gate: 10/10 checks -> ok" in capsys.readouterr().out
    rep = json.loads(out.read_text())
    assert rep["model"] == "bert_base" and rep["status"] == "ok"
    res = rep["phases"]["resume"]["result"]
    base = rep["phases"]["baseline"]
    assert (res["start_step"], res["resumed_from_serial"]) == (2, 2)
    assert res["final_step"] == base["final_step"] == 8
    assert res["final_loss"] == base["final_loss"]
    assert res["params_sha256"] == base["params_sha256"]
    assert rep["phases"]["kill"]["serials_after_kill"] == [2]
    assert [s["serial"] for s in res["skipped_checkpoints"]] == [4]
    # the CPU runs the kernels' plain versions: no launches counted
    assert set(res["launches"]) >= set(TC.ATTENTION_KERNELS)
    # kept: the serials the resume wrote after the promoted torn one
    kept = sorted(p.name for p in (tmp_path / "w" / "chaos_ckpts").iterdir()
                  if p.name.startswith("checkpoint_"))
    assert kept == ["checkpoint_2", "checkpoint_4", "checkpoint_6",
                    "checkpoint_8"]


def test_retries_off_fails_the_gate(tmp_path, capsys):
    out = tmp_path / "neg.json"
    assert TC.main(["--check", "--device", "cpu", "--negative-control",
                    "--workdir", str(tmp_path / "w"), "--json",
                    str(out)]) == 1
    assert "checks -> FAIL" in capsys.readouterr().out
    rep = json.loads(out.read_text())
    checks = {c["name"]: c["ok"] for c in rep["checks"]}
    assert rep["mode"] == "negative-control" and rep["status"] == "fail"
    # the kill and the torn write held; the resume is what failed
    assert checks["victim_killed"] and checks["torn_write_is_temp_dir"]
    assert checks["resume_completed"] is False
