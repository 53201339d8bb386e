"""``contrib.Trainer``/``Inferencer`` in the PyTorch port against the JAX
package on the CPU.

* The JAX suite's ``test_trainer_events_checkpoints_and_inferencer``
  (fit-a-line on ``dataset.uci_housing``) in both packages, the JAX
  trainer's initial weights carried into the port's: the same events,
  losses within f32 rtol 1e-5 / atol 1e-6, the same checkpoint rotation
  and resumed step count, and the ``Inferencer`` outputs within the same
  tolerance.
* A run stopped after step k and resumed from its checkpoint is
  bit-identical on the CPU to the uninterrupted run (losses and every
  parameter), through the data cursor's fast-forward over a seeded
  shuffle.
* The recovery walk passes a torn serial; an injected ``device_lost``
  fault leaves ``train()`` as a typed ``DeviceLostError`` with the last
  verified checkpoint intact; a graceful shutdown checkpoints and
  returns.
* ``parallel=True`` on one rank trains as the plain Trainer does, a
  sharded ``CheckpointConfig`` writes format 2, and
  ``Inferencer(parallel=True)`` infers as the plain one (two ranks:
  tests/test_torch_resilience_dist.py); ``Trainer()`` and
  ``Inferencer()`` with no place ask for CUDA."""
import json
import os

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu.unique_name as jun

import paddle_tpu_torch as tfluid
import paddle_tpu_torch.unique_name as tun
from paddle_tpu_torch import resilience
from paddle_tpu_torch.interop import scope_from_numpy
from paddle_tpu_torch.resilience import elastic, faults, graceful

RTOL, ATOL = 1e-5, 1e-6
CPU = tfluid.CPUPlace()


@pytest.fixture(autouse=True)
def _clean():
    yield
    faults.clear_plan()
    graceful.reset_shutdown_state()


def _train_func(fl):
    def f():
        x = fl.layers.data("x", shape=[13], dtype="float32")
        y = fl.layers.data("y", shape=[1], dtype="float32")
        pred = fl.layers.fc(x, 1, name="fit")
        return fl.layers.mean(fl.layers.square_error_cost(pred, y))
    return f


def _infer_func(fl):
    def f():
        x = fl.layers.data("x", shape=[13], dtype="float32")
        return fl.layers.fc(x, 1, name="fit")
    return f


def _trainer(ckpt_dir=None, every=5, keep=2, lr=0.01, **kw):
    ckpt = tfluid.contrib.CheckpointConfig(
        str(ckpt_dir), max_num_checkpoints=keep, step_interval=every) \
        if ckpt_dir else None
    with tun.guard():
        return tfluid.contrib.Trainer(
            _train_func(tfluid), lambda: tfluid.optimizer.SGD(lr),
            place=kw.pop("place", CPU), checkpoint_config=ckpt, **kw)


class _Events:
    def __init__(self, pkg):
        self.pkg, self.log, self.losses = pkg, [], []

    def __call__(self, ev):
        c = self.pkg.contrib
        for cls in (c.BeginEpochEvent, c.EndEpochEvent, c.BeginStepEvent,
                    c.EndStepEvent):
            if isinstance(ev, cls):
                self.log.append((cls.__name__, ev.epoch,
                                 getattr(ev, "step", None)))
        if isinstance(ev, c.EndStepEvent) and ev.metrics:
            self.losses.append(ev.metrics[0])


def _params(scope, names):
    return {n: np.asarray(scope.find_var(n)).copy() for n in names}


def test_trainer_events_checkpoints_and_inferencer_as_the_jax_package(
        tmp_path):
    runs = {}
    init = None
    for k, fl, un in (("jax", jfluid, jun), ("torch", tfluid, tun)):
        ckpt = fl.contrib.CheckpointConfig(str(tmp_path / k / "ckpt"),
                                           max_num_checkpoints=2,
                                           step_interval=5)
        kw = {"place": CPU} if k == "torch" else {}
        with un.guard():
            t = fl.contrib.Trainer(_train_func(fl),
                                   lambda fl=fl: fl.optimizer.SGD(0.01),
                                   checkpoint_config=ckpt, **kw)
        names = [p.name for p in t.main_program.all_parameters()]
        if k == "jax":
            init = _params(t.scope, names)
        else:
            scope_from_numpy(init, t.scope, CPU, [t.main_program])
        ev = _Events(fl)
        reader = fl.reader.batch(fl.dataset.uci_housing.train(),
                                 batch_size=32, drop_last=True)
        with un.guard():
            t.train(num_epochs=3, event_handler=ev, reader=reader,
                    feed_order=["x", "y"])
            t.save_params(str(tmp_path / k / "params"))
        kept = sorted(n for n in os.listdir(str(tmp_path / k / "ckpt"))
                      if n.startswith("checkpoint_"))
        with un.guard():
            inf = fl.contrib.Inferencer(_infer_func(fl),
                                        str(tmp_path / k / "params"), **kw)
        xb = np.random.RandomState(0).randn(4, 13).astype(np.float32)
        with un.guard():
            t2 = fl.contrib.Trainer(_train_func(fl),
                                    lambda fl=fl: fl.optimizer.SGD(0.01),
                                    checkpoint_config=ckpt, **kw)
        runs[k] = dict(events=ev.log, losses=np.array(ev.losses), kept=kept,
                       out=np.asarray(inf.infer({"x": xb})), step=t._step,
                       resumed=t2._step, params=_params(t.scope, names),
                       cursor=t2._resume_cursor.to_dict())
    j, t = runs["jax"], runs["torch"]
    assert t["events"] == j["events"]
    assert sum(e[0] == "EndEpochEvent" for e in t["events"]) == 3
    assert len(t["losses"]) == 36 and t["losses"][-1] < t["losses"][0]
    np.testing.assert_allclose(t["losses"], j["losses"], rtol=RTOL,
                               atol=ATOL)
    for n in t["params"]:
        np.testing.assert_allclose(t["params"][n], j["params"][n],
                                   rtol=RTOL, atol=ATOL)
    assert t["kept"] == j["kept"] and len(t["kept"]) == 2
    assert t["step"] == j["step"] == t["resumed"] == j["resumed"] == 36
    assert t["cursor"] == j["cursor"] == {"epoch": 3, "batch": 0}
    assert t["out"].shape == (4, 1)
    np.testing.assert_allclose(t["out"], j["out"], rtol=RTOL, atol=ATOL)


def _shuffled_reader(seed=11):
    return tfluid.reader.batch(
        tfluid.reader.shuffle(tfluid.dataset.uci_housing.train(), 128,
                              seed=seed), 32, drop_last=True)


class _Stop(Exception):
    pass


@pytest.mark.parametrize("stop_after", [4, 12, 17])
def test_resume_after_step_k_is_bit_identical(tmp_path, stop_after):
    """Uninterrupted: 2 epochs of 12 steps, checkpoints every 4 steps.
    Interrupted: the same run killed after step ``stop_after``, then a
    fresh Trainer on the same directory resumes from the last checkpoint
    (its seeded shuffle realigned by the cursor) and finishes."""
    full = _trainer(tmp_path / "full", every=4, keep=0)
    init = _params(full.scope, [p.name for p in
                                full.main_program.all_parameters()])
    ev_full = _Events(tfluid)
    full.train(2, ev_full, _shuffled_reader(), ["x", "y"])

    part = _trainer(tmp_path / "part", every=4, keep=0)
    scope_from_numpy(init, part.scope, CPU, [part.main_program])
    ev_part = _Events(tfluid)

    def killing(ev):
        ev_part(ev)
        # killed as step stop_after + 1 begins: step stop_after and its
        # checkpoint (if one was due) are done
        if isinstance(ev, tfluid.contrib.BeginStepEvent) and \
                part._step == stop_after:
            raise _Stop()

    with pytest.raises(_Stop):
        part.train(2, killing, _shuffled_reader(), ["x", "y"])
    done = ev_part.losses[:stop_after - stop_after % 4]
    resumed = _trainer(tmp_path / "part", every=4, keep=0)
    assert resumed._step == stop_after - stop_after % 4
    ev_res = _Events(tfluid)
    resumed.train(2, ev_res, _shuffled_reader(), ["x", "y"])
    np.testing.assert_array_equal(done + ev_res.losses, ev_full.losses)
    for n, v in _params(full.scope, init).items():
        np.testing.assert_array_equal(
            resumed.scope.find_var(n).numpy(), v)
    assert resumed._step == full._step == 24


def test_recovery_walks_past_a_torn_serial(tmp_path):
    t = _trainer(tmp_path / "ck", every=3, keep=0)
    t.train(1, lambda ev: None, _shuffled_reader(), ["x", "y"])
    serials = resilience.iter_serials(str(tmp_path / "ck"))
    assert [s for s, _ in serials] == [0, 1, 2, 3, 4]
    # the newest serial (the end-of-epoch save) loses its manifest, the
    # one before it a blob byte: both are passed over
    os.remove(os.path.join(serials[-1][1], "manifest.json"))
    blob = os.path.join(serials[-2][1], "ckpt.npz")
    data = bytearray(open(blob, "rb").read())
    data[len(data) // 2] ^= 0xFF
    open(blob, "wb").write(bytes(data))
    with open(os.path.join(serials[-3][1], "meta.json")) as f:
        want = json.load(f)
    back = _trainer(tmp_path / "ck", every=3, keep=0)
    assert back._step == want["step"] == 9
    assert back._resume_cursor.to_dict() == want["data_cursor"]


def test_injected_device_loss_leaves_train_typed(tmp_path):
    t = _trainer(tmp_path / "ck", every=2, keep=0)
    with faults.fault_plan_guard("device_lost:@5:RuntimeError"):
        with pytest.raises(elastic.DeviceLostError) as ei:
            t.train(1, lambda ev: None, _shuffled_reader(), ["x", "y"])
    assert ei.value.site == "step" and ei.value.transient is False
    assert t._step == 4
    back = _trainer(tmp_path / "ck", every=2, keep=0)
    assert back._step == 4
    assert back._resume_cursor.to_dict()["batch"] == 4


def test_a_lost_device_error_from_the_step_is_typed(tmp_path, monkeypatch):
    t = _trainer(tmp_path / "ck", every=100)
    real = t.exe.run

    def lost(*a, **k):
        if t._step == 2:
            raise RuntimeError("CUDA error: uncorrectable ECC error "
                               "encountered")
        return real(*a, **k)

    monkeypatch.setattr(t.exe, "run", lost)
    with pytest.raises(elastic.DeviceLostError):
        t.train(1, lambda ev: None, _shuffled_reader(), ["x", "y"])

    def program_fault(*a, **k):
        raise RuntimeError("CUDA error: device-side assert triggered")

    monkeypatch.setattr(t.exe, "run", program_fault)
    with pytest.raises(RuntimeError, match="device-side assert") as ei:
        t.train(1, lambda ev: None, _shuffled_reader(), ["x", "y"])
    assert not isinstance(ei.value, elastic.DeviceLostError)


def test_graceful_shutdown_checkpoints_and_returns(tmp_path):
    t = _trainer(tmp_path / "ck", every=100, keep=0)

    def handler(ev):
        if isinstance(ev, tfluid.contrib.EndStepEvent) and ev.step == 2:
            graceful.request_shutdown("test")

    t.train(2, handler, _shuffled_reader(), ["x", "y"])
    assert t.interrupted and t._step == 3
    serials = resilience.iter_serials(str(tmp_path / "ck"))
    assert len(serials) == 1
    with open(os.path.join(serials[0][1], "meta.json")) as f:
        meta = json.load(f)
    assert meta["step"] == 3 and meta["data_cursor"]["batch"] == 3


def test_parallel_and_sharded_wait_for_multi_device(tmp_path):
    """Ported: on one rank ``parallel=True`` trains bit for bit as the
    plain Trainer, ``sharded=True`` writes format-2 checkpoints the next
    Trainer resumes from, and ``Inferencer(parallel=True)`` infers as the
    plain one (two ranks: tests/test_torch_resilience_dist.py)."""
    runs = []
    for parallel in (False, True):
        t = _trainer(tmp_path / f"ck{parallel}", every=4, keep=0,
                     parallel=parallel)
        ev = _Events(tfluid)
        t.train(1, ev, _shuffled_reader(), ["x", "y"])
        runs.append((ev.losses, t))
    assert runs[0][0] == runs[1][0] and len(runs[0][0]) == 12
    t = runs[1][1]
    with tun.guard():
        sharded = tfluid.contrib.Trainer(
            _train_func(tfluid), lambda: tfluid.optimizer.SGD(0.01),
            place=CPU, parallel=True,
            checkpoint_config=tfluid.contrib.CheckpointConfig(
                str(tmp_path / "sh"), step_interval=4, sharded=True))
    sharded.train(1, lambda ev: None, _shuffled_reader(), ["x", "y"])
    serials = resilience.iter_serials(str(tmp_path / "sh"))
    assert serials and resilience.verify_checkpoint(
        serials[-1][1])["format_version"] == 2
    with tun.guard():
        again = tfluid.contrib.Trainer(
            _train_func(tfluid), lambda: tfluid.optimizer.SGD(0.01),
            place=CPU, checkpoint_config=tfluid.contrib.CheckpointConfig(
                str(tmp_path / "sh"), sharded=True))
    assert again._step == sharded._step
    t.save_params(str(tmp_path / "params"))
    x = np.ones((4, 13), np.float32)
    outs = []
    for p in (False, True):
        with tun.guard():
            inf = tfluid.contrib.Inferencer(
                _infer_func(tfluid), str(tmp_path / "params"), place=CPU,
                parallel=p)
        outs.append(inf.infer({"x": x}))
    np.testing.assert_array_equal(outs[0], outs[1])


def test_no_place_means_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("asserts the refusal on a machine without CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        with tun.guard():
            tfluid.contrib.Trainer(_train_func(tfluid),
                                   lambda: tfluid.optimizer.SGD(0.1))
    t = _trainer()
    t.save_params(str(tmp_path / "p"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        with tun.guard():
            tfluid.contrib.Inferencer(_infer_func(tfluid),
                                      str(tmp_path / "p"))
