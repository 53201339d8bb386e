"""``reader`` (the decorators, ``batch``, ``DataLoader``/``PyReader``) in
the PyTorch port, against the JAX package on the CPU.

* Every decorator gives the same sequence as the JAX package's on the
  same generators, exactly: ``shuffle`` with a seed over two epochs and
  its ``state_dict`` round trip, ``xmap_readers`` with ``order=True``,
  ``compose`` and its alignment check, ``multiprocess_reader``.
* ``DataLoader`` on ``CPUPlace`` hands out the batches ``DataFeeder``
  builds, bit for bit, as tensors the executor takes without a copy
  (``executor.mark_staged``); a tensor a caller feeds is still copied.
* The JAX suite's ``test_dataloader_trains_mnist`` runs in both packages
  from the same weights (the reference's scope carried across) on the
  same seeded shuffle: losses within f32 rtol 1e-5 / atol 1e-6.
* The mid-epoch ``state_dict`` resume of ``tests/test_resume.py``, a
  generator error raised in the consumer, ``PyReader``'s
  ``start``/``next``/``reset``, and no live worker after an early break.

Every wait on a thread here has a timeout of its own, so a hang fails
fast."""
import threading
import time

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu.unique_name as jun
from paddle_tpu import reader as jreader

import paddle_tpu_torch as tfluid
import paddle_tpu_torch.unique_name as tun
from paddle_tpu_torch import reader as treader
from paddle_tpu_torch.interop import scope_from_numpy

RTOL, ATOL = 1e-5, 1e-6
JOIN_S = 10.0
READERS = {"jax": jreader, "torch": treader}


def _ints(n=37):
    return lambda: iter(range(n))


def _pairs(n=23):
    return lambda: iter([(i, i * i) for i in range(n)])


def _both(make):
    """``make(reader_module)`` -> reader, for both packages."""
    return {k: make(m) for k, m in READERS.items()}


DECORATED = {
    "cache": lambda r: r.cache(_ints()),
    "map_readers": lambda r: r.map_readers(lambda a, b: a * 10 + b,
                                           _ints(), _ints(20)),
    "shuffle_seeded": lambda r: r.shuffle(_ints(), 8, seed=42),
    "chain": lambda r: r.chain(_ints(5), _pairs(4), _ints(3)),
    "compose": lambda r: r.compose(_ints(9), _pairs(9)),
    "compose_unchecked": lambda r: r.compose(_ints(9), _pairs(4),
                                             check_alignment=False),
    "buffered": lambda r: r.buffered(_pairs(), 3),
    "firstn": lambda r: r.firstn(_ints(), 11),
    "xmap_ordered": lambda r: r.xmap_readers(lambda v: v * 3, _ints(), 4,
                                             6, order=True),
    "multiprocess_one": lambda r: r.multiprocess_reader([_ints(12)]),
    "batch": lambda r: r.batch(_pairs(), 5),
    "batch_drop_last": lambda r: r.batch(_pairs(), 5, drop_last=True),
}


@pytest.mark.parametrize("name", sorted(DECORATED))
def test_decorator_sequences_equal_the_jax_package(name):
    """Two passes (epochs) of each decorated reader, element for element."""
    rd = _both(DECORATED[name])
    for _ in range(2):
        assert list(rd["torch"]()) == list(rd["jax"]())


def test_shuffle_state_dict_round_trip():
    """A seeded shuffle's ``state_dict`` resumes the next epoch's order in
    either package, and the states are interchangeable."""
    rd = _both(lambda r: r.shuffle(_ints(), 8, seed=9))
    first = {k: [list(r()), list(r())] for k, r in rd.items()}
    assert first["torch"] == first["jax"]
    assert first["torch"][0] != first["torch"][1]
    state = rd["torch"].state_dict()
    assert state == rd["jax"].state_dict() == {"seed": 9, "epoch": 2}
    fresh = _both(lambda r: r.shuffle(_ints(), 8, seed=9))
    fresh["jax"].set_state_dict(rd["torch"].state_dict())
    fresh["torch"].set_state_dict(rd["jax"].state_dict())
    assert list(fresh["torch"]()) == list(fresh["jax"]()) \
        == list(rd["torch"]())
    assert not hasattr(treader.shuffle(_ints(), 8), "state_dict")


def test_compose_misaligned_raises_in_both():
    for m in READERS.values():
        with pytest.raises(RuntimeError, match="different lengths"):
            list(m.compose(_ints(3), _ints(4))())


def test_xmap_unordered_and_multiprocess_give_the_same_multiset():
    for k, m in READERS.items():
        got = list(m.xmap_readers(lambda v: v + 1, _ints(), 3, 4)())
        assert sorted(got) == list(range(1, 38)), k
        fan = m.multiprocess_reader([_ints(10), _pairs(6)])
        assert sorted(map(str, fan())) == sorted(
            map(str, list(range(10)) + [(i, i * i) for i in range(6)])), k


def test_buffered_reraises_the_generator_error():
    def bad():
        yield 1
        raise KeyError("boom")

    for m in READERS.values():
        it = m.buffered(bad, 2)()
        assert next(it) == 1
        with pytest.raises(KeyError):
            next(it)


# ---------------------------------------------------------------- loader

def _mlp(fl, un):
    with un.guard():
        main, startup = fl.Program(), fl.Program()
        with fl.program_guard(main, startup):
            img = fl.layers.data("img", shape=[784], dtype="float32")
            label = fl.layers.data("label", shape=[1], dtype="int64")
            h = fl.layers.fc(img, 128, act="relu")
            logits = fl.layers.fc(h, 10)
            loss = fl.layers.mean(
                fl.layers.softmax_with_cross_entropy(logits, label))
            fl.optimizer.Adam(1e-3).minimize(loss)
    return main, startup, img, label, loss


def _jax_init(main, startup):
    exe = jfluid.Executor(jfluid.CPUPlace())
    scope = jfluid.Scope()
    with jfluid.scope_guard(scope):
        exe.run(startup)
    return exe, scope, {n: np.asarray(scope.find_var(n))
                        for n in list(scope.vars)}


def test_dataloader_trains_mnist_as_the_jax_package():
    """The JAX suite's ``test_dataloader_trains_mnist`` in both packages
    from the same weights, on the same seeded shuffle of
    ``dataset.mnist.train()`` (8192 samples, 128 batches of 64)."""
    jmain, jstart, jimg, jlabel, jloss = _mlp(jfluid, jun)
    tmain, tstart, timg, tlabel, tloss = _mlp(tfluid, tun)
    jexe, jscope, init = _jax_init(jmain, jstart)
    texe = tfluid.Executor(tfluid.CPUPlace())
    tscope = scope_from_numpy(init, tfluid.Scope(), tfluid.CPUPlace(),
                              [tmain])
    losses = {}
    for k, fl, exe, scope, feed, loss, main in (
            ("jax", jfluid, jexe, jscope, [jimg, jlabel], jloss, jmain),
            ("torch", tfluid, texe, tscope, [timg, tlabel], tloss, tmain)):
        loader = fl.DataLoader.from_generator(feed_list=feed, capacity=4)
        reader = fl.reader.shuffle(fl.dataset.mnist.train(), 1024, seed=3)
        loader.set_sample_generator(reader, batch_size=64,
                                    places=fl.CPUPlace())
        out = []
        with fl.scope_guard(scope):
            for batch in loader:
                assert tuple(batch["img"].shape) == (64, 784)
                assert tuple(batch["label"].shape) == (64, 1)
                out.append(float(np.asarray(exe.run(
                    main, feed=batch, fetch_list=[loss])[0]).reshape(-1)[0]))
        losses[k] = np.array(out)
    assert len(losses["torch"]) == 8192 // 64
    np.testing.assert_allclose(losses["torch"], losses["jax"], rtol=RTOL,
                               atol=ATOL)
    assert np.mean(losses["torch"][-10:]) < losses["torch"][0] * 0.5


def test_dataloader_batches_equal_data_feeder():
    """Each staged batch equals ``DataFeeder.feed`` of the same samples,
    bit for bit and dtype for dtype, as a CPU tensor the executor takes
    as it is."""
    from paddle_tpu_torch.executor import _staged_feed

    main, _start, img, label, _loss = _mlp(tfluid, tun)
    samples = list(tfluid.dataset.mnist.test()())[:96]
    feeder = tfluid.DataFeeder(feed_list=[img, label], program=main)
    loader = tfluid.DataLoader.from_generator(feed_list=[img, label],
                                              capacity=2)
    loader.set_sample_list_generator(
        tfluid.batch(lambda: iter(samples), 32), places=tfluid.CPUPlace())
    got = list(loader)
    assert len(got) == 3
    for i, b in enumerate(got):
        want = feeder.feed(samples[32 * i:32 * (i + 1)])
        for n in ("img", "label"):
            assert isinstance(b[n], torch.Tensor)
            assert b[n].numpy().dtype == want[n].dtype
            np.testing.assert_array_equal(b[n].numpy(), want[n])
            assert _staged_feed(b[n], torch.device("cpu"),
                                main.global_block.var(n).dtype)


def test_staged_tensor_is_not_copied_and_a_users_tensor_is():
    main, _start, img, label, _loss = _mlp(tfluid, tun)
    loader = tfluid.DataLoader.from_generator(feed_list=[img, label])
    loader.set_sample_list_generator(
        tfluid.batch(tfluid.dataset.mnist.test(), 8),
        places=tfluid.CPUPlace())
    staged = next(iter(loader))
    exe = tfluid.Executor(tfluid.CPUPlace())
    out = exe._feed_tensors(main, staged)
    assert out["img"] is staged["img"] and out["label"] is staged["label"]
    user = {"img": torch.zeros(8, 784),
            "label": torch.zeros(8, 1, dtype=torch.int64)}
    out = exe._feed_tensors(main, user)
    for n in user:
        assert out[n] is not user[n]
        assert out[n].data_ptr() != user[n].data_ptr()
        assert torch.equal(out[n], user[n])
    # a staged tensor in another dtype than the var's is copied (cast)
    cast = {"img": staged["img"].double(), "label": staged["label"]}
    tfluid.executor.mark_staged(cast["img"])
    out = exe._feed_tensors(main, cast)
    assert out["img"] is not cast["img"] and out["img"].dtype == \
        torch.float32


def _samples():
    rng = np.random.RandomState(0)
    return [(rng.rand(4).astype(np.float32),
             rng.rand(1).astype(np.float32)) for _ in range(64)]


def _resume_prog(fl, un):
    with un.guard():
        main, startup = fl.Program(), fl.Program()
        with fl.program_guard(main, startup):
            x = fl.layers.data("x", shape=[4], dtype="float32")
            y = fl.layers.data("y", shape=[1], dtype="float32")
            pred = fl.layers.fc(x, 1)
            loss = fl.layers.mean(fl.layers.square_error_cost(pred, y))
            fl.optimizer.SGD(0.1).minimize(loss)
    return main, startup, x, y, loss


def _resume_loader(fl, x, y):
    loader = fl.DataLoader.from_generator(feed_list=[x, y], capacity=2)
    loader.set_sample_generator(lambda: iter(_samples()), batch_size=8,
                                drop_last=True, places=fl.CPUPlace())
    return loader


def test_dataloader_state_dict_resumes_mid_epoch():
    """``tests/test_resume.py``'s mid-epoch resume through the port: 2
    epochs of 8 batches, a crash after 5, params and the loader state
    restored in a fresh loader; the losses equal the uninterrupted run's
    and the JAX package's uninterrupted run's."""
    jmain, jstart, jx, jy, jloss = _resume_prog(jfluid, jun)
    main, start, x, y, loss = _resume_prog(tfluid, tun)
    jexe, jscope, init = _jax_init(jmain, jstart)
    jfull = []
    with jfluid.scope_guard(jscope):
        jl = _resume_loader(jfluid, jx, jy)
        for _ in range(2):
            for b in jl:
                jfull.append(float(np.asarray(jexe.run(
                    jmain, feed=b, fetch_list=[jloss])[0]).reshape(-1)[0]))

    def run(loader, exe, scope, n=None):
        out = []
        for b in loader:
            out.append(float(np.asarray(exe.run(
                main, feed=b, fetch_list=[loss], scope=scope)[0])
                .reshape(-1)[0]))
            if n is not None and len(out) == n:
                break
        return out

    exe = tfluid.Executor(tfluid.CPUPlace())
    place = tfluid.CPUPlace()
    full_scope = scope_from_numpy(init, tfluid.Scope(), place, [main])
    full_loader = _resume_loader(tfluid, x, y)
    full = run(full_loader, exe, full_scope) + run(full_loader, exe,
                                                   full_scope)
    s2 = scope_from_numpy(init, tfluid.Scope(), place, [main])
    l2 = _resume_loader(tfluid, x, y)
    part = run(l2, exe, s2, n=5)
    ck = l2.state_dict()
    assert ck == {"epoch": 0, "batch": 5}
    params = {n: s2.find_var(n).numpy().copy() for n in list(s2.vars)}
    s3 = scope_from_numpy(params, tfluid.Scope(), place, [main])
    l3 = _resume_loader(tfluid, x, y)
    l3.set_state_dict(ck)
    part += run(l3, exe, s3)
    assert l3.state_dict() == {"epoch": 1, "batch": 0}
    part += run(l3, exe, s3)
    assert len(full) == 16
    np.testing.assert_array_equal(part, full)
    np.testing.assert_allclose(full, jfull, rtol=RTOL, atol=ATOL)


def test_generator_error_reaches_the_consumer():
    def gen():
        yield (np.ones((2, 4), np.float32), np.ones((2, 1), np.float32))
        raise ZeroDivisionError("reader failed")

    loader = tfluid.DataLoader.from_generator(feed_list=["x", "y"])
    loader.set_batch_generator(gen, places=tfluid.CPUPlace())
    it = iter(loader)
    first = next(it)
    assert tuple(first["x"].shape) == (2, 4)
    with pytest.raises(ZeroDivisionError, match="reader failed"):
        next(it)
    assert loader._worker is None


def test_pyreader_start_next_reset():
    main, _start, img, label, _loss = _mlp(tfluid, tun)
    r = tfluid.PyReader(feed_list=[img, label], capacity=2, return_list=True)
    r.decorate_sample_list_generator(
        tfluid.batch(tfluid.dataset.mnist.test(), 16),
        places=tfluid.CPUPlace())
    with pytest.raises(RuntimeError, match="start"):
        r.next()
    r.start()
    a = r.next()
    b = r.next()
    assert tuple(a[0].shape) == (16, 784) and tuple(b[1].shape) == (16, 1)
    assert not torch.equal(a[0], b[0])
    worker = r._worker
    r.reset()
    assert not worker.is_alive()
    r.start()
    again = r.next()
    assert torch.equal(again[0], a[0])
    r.reset()


def test_breaking_out_early_leaves_no_live_worker():
    """A consumer that leaves after one batch, with the worker parked on
    a full queue, stops it: no thread of the loader stays alive."""
    produced = []

    def many():
        for i in range(1000):
            produced.append(i)
            yield (np.full((2, 4), i, np.float32),
                   np.zeros((2, 1), np.float32))

    loader = tfluid.DataLoader.from_generator(feed_list=["x", "y"],
                                              capacity=2)
    loader.set_batch_generator(many, places=tfluid.CPUPlace())
    before = {t.ident for t in threading.enumerate()}
    for batch in loader:
        worker = loader._worker
        deadline = time.monotonic() + JOIN_S
        while len(produced) < 3 and time.monotonic() < deadline:
            time.sleep(0.01)     # let the worker fill the queue
        break
    worker.join(timeout=JOIN_S)
    assert not worker.is_alive()
    assert loader._worker is None
    assert len(produced) < 1000
    left = [t for t in threading.enumerate()
            if t.ident not in before and t.name.startswith(
                "paddle_tpu_torch-dataloader")]
    assert not left


def test_loader_without_places_stages_to_the_card():
    """``places=None`` means ``CUDAPlace(0)``: it raises without a card."""
    loader = tfluid.DataLoader.from_generator(feed_list=["x"])
    if torch.cuda.is_available():
        loader.set_batch_generator(lambda: iter([]))
        assert loader._device == torch.device("cuda", 0)
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            loader.set_batch_generator(lambda: iter([]))


def test_batch_lends_the_shuffle_state():
    """The port's ``batch`` over a seeded shuffle carries its resume
    state, so a cursor replays a later epoch's order through it (the
    JAX package's ``batch`` carries none)."""
    r = treader.batch(treader.shuffle(_ints(), 8, seed=5), 4)
    epochs = [list(r()), list(r())]
    assert r.state_dict() == {"seed": 5, "epoch": 2}
    again = treader.batch(treader.shuffle(_ints(), 8, seed=5), 4)
    again.set_state_dict({"seed": 5, "epoch": 1})
    assert list(again()) == epochs[1]
    assert not hasattr(treader.batch(_ints(), 4), "state_dict")
    assert not hasattr(jreader.batch(jreader.shuffle(_ints(), 8, seed=5),
                                     4), "state_dict")
