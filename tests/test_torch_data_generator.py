"""``incubate.data_generator`` in the PyTorch port against the JAX
package's, on the CPU: each generator's output lines are equal, string
for string, from memory and from stdin, batched and not; the errors are
the same; and the port's MultiSlot parser reads the lines back."""
import io
import sys

import numpy as np
import pytest

import paddle_tpu.incubate.data_generator as jdg

import paddle_tpu_torch.incubate.data_generator as tdg
from paddle_tpu_torch.dataset_feed import DatasetFactory

MODULES = {"jax": jdg, "torch": tdg}
LINES = ["3 1 2 3 1", "1 7 0", "2 4 5 1", "4 9 8 7 6 0", "1 1 1"]


def _sample_gens(mod):
    """Generators of each kind over the same parsed samples."""

    class Ids(mod.MultiSlotDataGenerator):
        def generate_sample(self, line):
            def it():
                if line is None:
                    for i in range(7):
                        yield [("ids", [i, i + 1, 2 * i]),
                               ("label", [i % 2])]
                    yield None       # skipped
                    return
                toks = [int(t) for t in line.split()]
                n = toks[0]
                yield [("ids", toks[1:1 + n]), ("label", [toks[-1]])]
            return it

    class Floats(mod.MultiSlotDataGenerator):
        def generate_sample(self, line):
            def it():
                for i in range(5):
                    yield [("dense", [0.5 * i, 1.25, float(i)]),
                           ("flag", [True, False, i])]
            return it

    class Strings(mod.MultiSlotStringDataGenerator):
        def generate_sample(self, line):
            def it():
                for w in ("a b", "c", "d e f"):
                    yield [("words", w.split()), ("label", ["1"])]
            return it

    class Pairs(mod.MultiSlotDataGenerator):
        def generate_sample(self, line):
            def it():
                for i in range(6):
                    yield [("q", [i]), ("d", [i + 10])]
            return it

        def generate_batch(self, samples):
            def it():
                for s in reversed(samples):    # a batch-level reorder
                    yield s
            return it

    return {"ids": Ids, "floats": Floats, "strings": Strings,
            "pairs": Pairs}


def _run(gen, mode, monkeypatch, batch=None):
    out = io.StringIO()
    monkeypatch.setattr(sys, "stdout", out)
    if mode == "stdin":
        monkeypatch.setattr(sys, "stdin", io.StringIO(
            "\n".join(LINES) + "\n"))
    if batch:
        gen.set_batch(batch)
    getattr(gen, "run_from_" + mode)()
    monkeypatch.undo()
    return out.getvalue()


@pytest.mark.parametrize("kind,mode,batch", [
    ("ids", "memory", None), ("ids", "memory", 3), ("ids", "stdin", None),
    ("ids", "stdin", 2), ("floats", "memory", None),
    ("floats", "memory", 4), ("strings", "memory", None),
    ("pairs", "memory", 4), ("pairs", "memory", 6)])
def test_output_lines_equal_the_jax_package(kind, mode, batch,
                                            monkeypatch):
    outs = {k: _run(_sample_gens(m)[kind](), mode, monkeypatch, batch)
            for k, m in MODULES.items()}
    assert outs["torch"] == outs["jax"]
    assert outs["torch"].endswith("\n") and outs["torch"].count("\n") >= 3


def test_slot_types_and_line_limit_track_alike(monkeypatch):
    gens = {k: _sample_gens(m)["floats"]() for k, m in MODULES.items()}
    for g in gens.values():
        _run(g, "memory", monkeypatch)
    assert gens["torch"]._proto_info == gens["jax"]._proto_info == \
        [("dense", "float"), ("flag", "uint64")]
    limited = {}
    for k, m in MODULES.items():
        g = _sample_gens(m)["ids"]()
        g._set_line_limit(2)
        limited[k] = _run(g, "stdin", monkeypatch)
    assert limited["torch"] == limited["jax"]
    assert limited["torch"].count("\n") == 2
    for m in MODULES.values():
        with pytest.raises(ValueError):
            m.DataGenerator()._set_line_limit(0)


@pytest.mark.parametrize("bad", [
    "not a list", [("ids", [])], [("ids", (1, 2))], [(3, [1])],
    [("ids", ["x"])]])
def test_errors_equal_the_jax_package(bad):
    msgs = {}
    for k, m in MODULES.items():
        with pytest.raises(ValueError) as ei:
            m.MultiSlotDataGenerator()._gen_str(bad)
        msgs[k] = str(ei.value)
    assert msgs["torch"] == msgs["jax"]


def test_mismatched_second_sample_errors_alike():
    msgs = {}
    for k, m in MODULES.items():
        g = m.MultiSlotDataGenerator()
        g._gen_str([("a", [1]), ("b", [2])])
        with pytest.raises(ValueError) as e1:
            g._gen_str([("a", [1])])
        with pytest.raises(ValueError) as e2:
            g._gen_str([("a", [1]), ("c", [2])])
        msgs[k] = (str(e1.value), str(e2.value))
    assert msgs["torch"] == msgs["jax"]
    for m in MODULES.values():
        with pytest.raises(NotImplementedError):
            m.DataGenerator()._gen_str([("a", [1])])


def test_lines_read_back_through_the_port_parser(tmp_path, monkeypatch):
    text = _run(_sample_gens(tdg)["ids"](), "memory", monkeypatch)
    p = tmp_path / "part-0.txt"
    p.write_text(text)
    ds = DatasetFactory().create_dataset("QueueDataset")
    ds.set_use_var([("ids", "int64", 3), ("label", "int64", 1)])
    ds.set_filelist([str(p)])
    ds.set_batch_size(7)
    (b,) = list(ds.iter_batches())
    np.testing.assert_array_equal(
        b["ids"], [[i, i + 1, 2 * i] for i in range(7)])
    np.testing.assert_array_equal(b["label"].ravel(),
                                  [i % 2 for i in range(7)])
