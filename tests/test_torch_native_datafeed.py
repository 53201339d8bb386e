"""The PyTorch port's native MultiSlot feed (``native/datafeed.cpp``, its
own copy, built with g++ into ``paddle_tpu_torch/_build/native/``) and
``dataset_feed``, against the JAX package's engine on the CPU.

* The port's native engine, its Python parser and the JAX package's
  engine give equal batches on the same files: exactly, in order, on one
  thread; as a multiset of rows on several.
* Malformed rows are counted and skipped alike by both parsers; blank
  lines are no error.
* Abandoning an iteration with producers parked on a full queue does not
  deadlock (the iteration runs in a thread joined with a timeout).
* Slot names and dtypes are validated; ``DataLoader.set_batch_generator``
  stages the engine's batches unchanged.
* The port builds only under ``paddle_tpu_torch/_build/``."""
import os
import threading

import numpy as np
import pytest

from paddle_tpu.dataset_feed import DatasetFactory as JFactory

import paddle_tpu_torch as tfluid
from paddle_tpu_torch import native
from paddle_tpu_torch.dataset_feed import DatasetFactory

JOIN_S = 30.0


def _write_files(tmp_path, n_files=3, rows_per_file=40, seed=0):
    """MultiSlot protocol: '<num> <v...>' per slot; slots: feat f32[4],
    ids i64[3], label i64[1]."""
    rng = np.random.RandomState(seed)
    paths = []
    for fi in range(n_files):
        p = tmp_path / f"part-{fi}.txt"
        with open(p, "w") as f:
            for _ in range(rows_per_file):
                feat = rng.randn(4).astype(np.float32)
                ids = rng.randint(0, 10 ** 12, 3)
                f.write("4 " + " ".join(f"{v:.6f}" for v in feat)
                        + " 3 " + " ".join(str(int(v)) for v in ids)
                        + f" 1 {int(rng.randint(0, 2))}\n")
        paths.append(str(p))
    return paths


SLOTS = [("feat", "float32", 4), ("ids", "int64", 3), ("label", "int64", 1)]


def _make(factory, paths, batch=16, threads=1):
    ds = factory().create_dataset("QueueDataset")
    ds.set_use_var(SLOTS)
    ds.set_filelist(paths)
    ds.set_thread(threads)
    ds.set_batch_size(batch)
    return ds


def _assert_batches_equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.keys() == y.keys()
        for n in x:
            assert x[n].dtype == y[n].dtype and x[n].shape == y[n].shape
            np.testing.assert_array_equal(x[n], y[n])


def _rows(batches):
    """Every row as a tuple of its slots' bytes, sorted (a multiset)."""
    out = []
    for b in batches:
        for i in range(len(b["label"])):
            out.append(tuple(b[n][i].tobytes() for n, _, _ in SLOTS))
    return sorted(out)


def test_native_engine_builds_under_the_port(tmp_path):
    lib = native.load_datafeed()
    assert lib is not None, native.build_error()
    pkg = os.path.dirname(os.path.abspath(tfluid.__file__))
    assert native.BUILD_DIR == os.path.join(pkg, "_build", "native")
    assert os.path.dirname(lib._name) == native.BUILD_DIR
    assert os.path.basename(lib._name).startswith("datafeed_")
    src = os.path.join(os.path.dirname(native.__file__), "datafeed.cpp")
    assert os.path.exists(src) and src.startswith(pkg)
    assert _make(DatasetFactory, []).using_native


@pytest.mark.parametrize("batch", [1, 7, 16, 120])
def test_native_python_and_jax_engines_agree_in_order(tmp_path, batch):
    paths = _write_files(tmp_path)
    port = list(_make(DatasetFactory, paths, batch).iter_batches())
    py = list(_make(DatasetFactory, paths, batch)._iter_python())
    jax_side = list(_make(JFactory, paths, batch).iter_batches())
    assert sum(len(b["label"]) for b in port) == 120
    _assert_batches_equal(port, py)
    _assert_batches_equal(port, jax_side)


def test_batches_larger_than_the_queue_keep_their_order(tmp_path):
    """A batch of more rows than the queue holds leaves it in several bulk
    takes, in order."""
    paths = _write_files(tmp_path, n_files=2, rows_per_file=90)
    ds = _make(DatasetFactory, paths, 50)
    ds.set_queue_capacity(16)
    port = list(ds.iter_batches())
    assert [len(b["label"]) for b in port] == [50, 50, 50, 30]
    _assert_batches_equal(port, list(_make(DatasetFactory, paths,
                                           50)._iter_python()))


def test_several_threads_give_the_same_rows(tmp_path):
    paths = _write_files(tmp_path, n_files=6, rows_per_file=50)
    port = list(_make(DatasetFactory, paths, 32, threads=4).iter_batches())
    jax_side = list(_make(JFactory, paths, 32, threads=4).iter_batches())
    py = list(_make(DatasetFactory, paths, 32)._iter_python())
    assert _rows(port) == _rows(py) == _rows(jax_side)
    assert len(_rows(port)) == 300


def test_malformed_rows_are_counted_and_skipped(tmp_path):
    p = tmp_path / "bad.txt"
    with open(p, "w") as f:
        f.write("4 1 2 3 4 3 1 2 3 1 0\n")        # good
        f.write("3 1 2 3 3 1 2 3 1 0\n")          # wrong slot length
        f.write("4 1 2 oops 4 3 1 2 3 1 0\n")     # not a number
        f.write("\n   \n")                        # blank: no error
        f.write("4 1 2 3 4 3 1 2\n")              # truncated
        f.write("4 9 9 9 9 3 7 8 9 1 1\n")        # good
    for ds, it in ((_make(DatasetFactory, [str(p)], 8), "iter_batches"),
                   (_make(DatasetFactory, [str(p)], 8), "_iter_python"),
                   (_make(JFactory, [str(p)], 8), "iter_batches")):
        batches = list(getattr(ds, it)())
        assert sum(len(b["label"]) for b in batches) == 2
        assert ds.parse_errors() == 3
        np.testing.assert_array_equal(batches[0]["ids"],
                                      [[1, 2, 3], [7, 8, 9]])


def test_abandoning_an_iteration_does_not_deadlock(tmp_path):
    paths = _write_files(tmp_path, n_files=1, rows_per_file=2000)
    ds = _make(DatasetFactory, paths, batch=8, threads=2)
    ds.set_queue_capacity(16)     # producers park on a full queue
    done = threading.Event()

    def abandon():
        it = ds.iter_batches()
        next(it)
        it.close()                # generator finally -> stop and join
        done.set()

    t = threading.Thread(target=abandon, daemon=True)
    t.start()
    t.join(timeout=JOIN_S)
    assert done.is_set(), "df_stop_join did not return"


def test_slot_validation():
    ds = DatasetFactory().create_dataset()
    with pytest.raises(ValueError, match="may not contain"):
        ds.set_use_var([("a:b", "float32", 1)])
    with pytest.raises(ValueError, match="may not contain"):
        ds.set_use_var([("a,b", "int64", 1)])
    with pytest.raises(ValueError, match="float32 or int64"):
        ds.set_use_var([("a", "int32", 1)])
    with pytest.raises(RuntimeError, match="set_use_var"):
        next(ds.iter_batches())
    ds.set_use_var([("a", "float32", 2)])
    with pytest.raises(RuntimeError, match="set_filelist"):
        next(ds.iter_batches())
    with pytest.raises(ValueError, match="unknown dataset class"):
        DatasetFactory().create_dataset("NoSuchDataset")
    for cls in ("QueueDataset", "InMemoryDataset", "MultiSlotDataset"):
        assert DatasetFactory().create_dataset(cls) is not None


def test_loader_stages_the_engine_batches_unchanged(tmp_path):
    paths = _write_files(tmp_path, n_files=2)
    ds = _make(DatasetFactory, paths, batch=16)
    want = list(_make(DatasetFactory, paths, batch=16).iter_batches())
    loader = tfluid.DataLoader.from_generator(
        feed_list=["feat", "ids", "label"], capacity=3)
    loader.set_batch_generator(ds.iter_batches, places=tfluid.CPUPlace())
    got = [{n: t.numpy() for n, t in b.items()} for b in loader]
    _assert_batches_equal(got, want)
