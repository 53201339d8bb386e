"""``tools/torch_remat_check.py`` against the JAX package's
``tools/remat_check.py`` on the CPU: the same gate values (segments,
candidates, checkpoints, predicted peaks, drop, budget fit) on BERT-base
and the MLP, the same gate verdicts; the card's BERT leg rehearsed at
BERT-tiny width (bit-identical losses with and without remat); the flag-off
tripwire fails the gate when the transform leaks into an un-flagged run."""
import numpy as np
import pytest
import torch

from tools import remat_check as JR
from tools import torch_gate_probes as probes
from tools import torch_remat_check as TR

_PLAN_KEYS = ("applied", "segments", "candidates", "checkpoints",
              "budget_bytes", "batch_size")
_PEAKS = ("predicted_peak_bytes_plain", "predicted_peak_bytes_remat")
# the port keeps mask_label's two unsqueezes ([B, 128, 1]) int64 where the
# JAX package's x64-off canonicalisation stores int32: at batch 64 each
# adds this many bytes to a peak it is live at
INT64_WIDENING = 64 * 128 * (8 - 4)


@pytest.fixture(autouse=True)
def _cpu():
    probes.set_device("cpu")
    yield
    probes.set_device("cuda")


@pytest.fixture
def one_thread():
    """The CPU's accumulating ``index_put_`` (the embedding grads) adds
    with atomics across threads; one thread repeats bit for bit."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _gates(report):
    return [(g["name"], g["ok"]) for g in report["gates"]]


def test_bert_gate_values_equal_the_jax_tools():
    """Segments, candidates, checkpoints and the budget as the JAX tool's;
    the predicted peaks equal but for the port's int64 label vars."""
    jrep, trep = {"gates": []}, {"gates": []}
    assert JR.check_bert(jrep) and TR.check_bert(trep)
    for key in ("bert", "bert_budget"):
        assert {k: trep[key][k] for k in _PLAN_KEYS} == \
            {k: jrep[key][k] for k in _PLAN_KEYS}, key
        for k in _PEAKS:
            extra = trep[key][k] - jrep[key][k]
            assert extra % INT64_WIDENING == 0, (key, k, extra)
            assert 0 <= extra <= 2 * INT64_WIDENING, (key, k, extra)
            assert trep[key][k] >> 20 == jrep[key][k] >> 20, (key, k)
    assert trep["bert_budget"]["budget_mb"] == jrep["bert_budget"]["budget_mb"]
    assert _gates(trep) == _gates(jrep)
    assert TR.MIN_PEAK_DROP == JR.MIN_PEAK_DROP


def test_mlp_tripwire_and_bit_exactness_equal_the_jax_tools():
    jrep, trep = {"gates": []}, {"gates": []}
    assert JR.check_negative_and_bitexact(jrep)
    assert TR.check_negative_and_bitexact(trep)
    assert trep["negative_control"] == jrep["negative_control"]
    assert trep["bit_exact"]["remat_segments"] == \
        jrep["bit_exact"]["remat_segments"]
    assert trep["bit_exact"]["plain"] == trep["bit_exact"]["remat"]
    assert _gates(trep) == _gates(jrep)


def test_the_card_leg_rehearsed_at_bert_tiny_width(one_thread):
    rep = {"gates": []}
    assert TR.check_bert_train(rep, tiny=True)
    bt = rep["bert_train"]
    assert bt["plain"]["segments"] == 0 and bt["remat"]["segments"] > 0
    assert bt["plain"]["losses"] == bt["remat"]["losses"]
    assert len(bt["plain"]["losses"]) == TR.TRAIN_STEPS
    assert np.all(np.isfinite(bt["plain"]["losses"]))
    assert bt["remat"]["predicted_peak_bytes"] < \
        bt["plain"]["predicted_peak_bytes"]
    # the measured peak is the card's
    assert bt["plain"]["measured_peak_bytes"] is None


def test_a_transform_leaking_into_unflagged_runs_trips_the_gate(
        monkeypatch, capsys):
    """The negative control inside the gate: an executor whose remat hook
    ignored FLAGS_auto_recompute=0 fails ``negative_control``."""
    import paddle_tpu_torch.executor as texecutor
    from paddle_tpu_torch.flags import flag

    real = texecutor.Executor._maybe_auto_remat

    def leaky(self, program, feed, fetch_names):
        if flag("auto_recompute"):
            return real(self, program, feed, fetch_names)
        from paddle_tpu_torch.flags import set_flags
        set_flags({"FLAGS_auto_recompute": True})
        try:
            return real(self, program, feed, fetch_names)
        finally:
            set_flags({"FLAGS_auto_recompute": False})

    monkeypatch.setattr(texecutor.Executor, "_maybe_auto_remat", leaky)
    rep = {"gates": []}
    assert not TR.check_negative_and_bitexact(rep)
    assert dict(_gates(rep))["negative_control"] is False
    assert "[FAIL] negative_control" in capsys.readouterr().out


def test_cli_exits_0_and_writes_the_report(tmp_path, monkeypatch):
    monkeypatch.setattr(TR, "check_bert", lambda report: True)
    out = tmp_path / "remat.json"
    assert TR.main(["--check", "--device", "cpu", "--json", str(out)]) == 0
    assert out.exists()
