"""Graceful preemption in the PyTorch port (``resilience.graceful``): the
cases of ``tests/test_elastic.py`` for the shutdown event, the
refcounted signal handlers, retry backoffs that wake on the event, and
the serving engine's drain-stop; and a training loop stopped by a real
SIGTERM between steps that checkpoints from ``on_shutdown`` and resumes
from ``load_latest_checkpoint`` (the loop of
``paddle_tpu/contrib/trainer.py``, whose ``Trainer`` the port does not
have yet). Every test leaves the shutdown state reset and the previous
SIGTERM handler installed."""
import os
import signal
import threading
import time

import numpy as np
import pytest

import paddle_tpu_torch as fluid
import paddle_tpu_torch.unique_name as un
from paddle_tpu_torch import monitor, resilience, serving
from paddle_tpu_torch.resilience import graceful
from paddle_tpu_torch.resilience.retry import (RetryExhaustedError,
                                               RetryPolicy, call_with_retry,
                                               set_thread_stop_event)


@pytest.fixture(autouse=True)
def _clean():
    from paddle_tpu_torch import clip as tclip

    tclip._clip_attr["__global__"] = None
    prev = signal.getsignal(signal.SIGTERM)
    graceful.reset_shutdown_state()
    yield
    set_thread_stop_event(None)
    graceful.reset_shutdown_state()
    graceful._installed.clear()
    signal.signal(signal.SIGTERM, prev)


def test_serving_engine_drains_on_shutdown_request():
    """install_preemption_handler: a shutdown request drains the queue
    (every request reaches its terminal outcome) and flips ready()
    false; the drain-stop releases the engine's hold on the handler."""
    with un.guard():
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            x = fluid.layers.data("x", shape=[5], dtype="float32")
            pred = fluid.layers.fc(x, 3)
        infer = main.clone(for_test=True)
    exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    exe.run(startup, scope=scope)
    eng = serving.ServingEngine(
        infer, feed_names=["x"], fetch_list=[pred.name], scope=scope,
        executor=exe, config=serving.ServingConfig(max_batch=4))
    prev = signal.getsignal(signal.SIGTERM)
    eng.start()
    assert eng.install_preemption_handler()
    assert signal.getsignal(signal.SIGTERM) is not prev
    futs = [eng.submit({"x": np.random.RandomState(i)
                        .rand(1, 5).astype(np.float32)})
            for i in range(6)]
    graceful.request_shutdown("test")
    for f in futs:
        r = f.result(timeout=30)
        assert np.asarray(r[0]).shape == (1, 3)
    deadline = time.monotonic() + 30
    while eng.ready() and time.monotonic() < deadline:
        time.sleep(0.02)
    assert not eng.ready()
    acct = eng.accounting()
    assert acct["exact"] and acct["pending"] == 0
    # the drain-stop released the engine's hold on the handler (it ran
    # on the callback thread, where the restore itself is a no-op and
    # the event-setting handler stays, as in the JAX package)
    assert signal.SIGTERM not in graceful._installed
    assert not eng.install_preemption_handler()   # stopped: refused
    monitor.reset()


def test_retry_backoff_wakes_on_thread_stop_event():
    ev = threading.Event()
    set_thread_stop_event(ev)
    threading.Timer(0.15, ev.set).start()
    pol = RetryPolicy(max_attempts=5, base_delay=30.0, max_delay=30.0,
                      timeout=None)
    t0 = time.monotonic()
    with pytest.raises(RetryExhaustedError):
        call_with_retry("compile",
                        lambda: (_ for _ in ()).throw(
                            RuntimeError("transient")), policy=pol)
    assert time.monotonic() - t0 < 5.0   # not the 30s backoff


def test_retry_backoff_wakes_on_global_shutdown():
    threading.Timer(0.15, graceful.request_shutdown, args=("t",)).start()
    pol = RetryPolicy(max_attempts=5, base_delay=30.0, max_delay=30.0,
                      timeout=None)
    t0 = time.monotonic()
    with pytest.raises(RetryExhaustedError):
        call_with_retry("compile",
                        lambda: (_ for _ in ()).throw(
                            RuntimeError("transient")), policy=pol)
    assert time.monotonic() - t0 < 5.0


def test_signal_handlers_are_refcounted():
    prev = signal.getsignal(signal.SIGTERM)
    assert graceful.install_signal_handlers()   # engine's hold
    ours = signal.getsignal(signal.SIGTERM)
    assert ours is not prev
    assert graceful.install_signal_handlers()   # trainer's hold
    graceful.uninstall_signal_handlers()        # trainer exits
    assert signal.getsignal(signal.SIGTERM) is ours
    graceful.uninstall_signal_handlers()        # last owner exits
    assert signal.getsignal(signal.SIGTERM) is prev


def test_graceful_on_shutdown_runs_late_registrations():
    graceful.request_shutdown("early")
    ran = threading.Event()
    unregister = graceful.on_shutdown(ran.set)
    assert ran.wait(5.0)   # registered after the fact: runs immediately
    unregister()
    assert graceful.shutdown_reason() == "early"


def test_sigterm_between_steps_checkpoints_and_resumes(tmp_path):
    """SIGTERM lands between two steps: the handler only sets the event,
    the loop stops at ``shutdown_requested()``, the ``on_shutdown`` save
    writes a verified checkpoint holding the step, and a fresh executor
    and scope resume from it with the losses of an uninterrupted run."""
    def build():
        with un.guard():
            main, startup = fluid.Program(), fluid.Program()
            with fluid.program_guard(main, startup):
                x = fluid.layers.data("x", shape=[4], dtype="float32")
                y = fluid.layers.data("y", shape=[1], dtype="float32")
                d = fluid.layers.elementwise_sub(fluid.layers.fc(x, 1), y)
                loss = fluid.layers.mean(fluid.layers.elementwise_mul(d, d))
                fluid.optimizer.SGD(0.1).minimize(loss)
        return main, startup, loss

    rng = np.random.RandomState(0)
    feeds = [{"x": rng.rand(8, 4).astype(np.float32),
              "y": rng.rand(8, 1).astype(np.float32)} for _ in range(6)]
    main, startup, loss = build()
    exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    exe.run(startup, scope=scope)
    init = {n: scope.numpy(n).copy() for n in scope.vars}
    want = [float(exe.run(main, feed=f, fetch_list=[loss],
                          scope=scope)[0]) for f in feeds]

    exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    for n, a in init.items():
        scope.set_var(n, a.copy())
    step = [0]
    saved = threading.Event()

    def save():
        fluid.io.save_checkpoint(
            exe, str(tmp_path / f"checkpoint_{step[0]}"), main,
            scope=scope, meta={"step": step[0]})
        saved.set()

    assert resilience.install_signal_handlers()
    unregister = resilience.on_shutdown(save)
    got = []
    try:
        for f in feeds:
            if resilience.shutdown_requested():
                break
            got.append(float(exe.run(main, feed=f, fetch_list=[loss],
                                     scope=scope)[0]))
            step[0] += 1
            if step[0] == 3:
                os.kill(os.getpid(), signal.SIGTERM)
                # the handler runs between bytecodes on the main thread
                deadline = time.monotonic() + 10
                while not resilience.shutdown_requested() and \
                        time.monotonic() < deadline:
                    time.sleep(0.01)
        assert saved.wait(30)
    finally:
        unregister()
        resilience.uninstall_signal_handlers()
    assert step[0] == 3 and got == want[:3]
    exe2, scope2 = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    meta, serial, skipped = resilience.load_latest_checkpoint(
        exe2, str(tmp_path), main_program=main, scope=scope2)
    assert (meta["step"], serial, skipped) == (3, 3, [])
    rest = [float(exe2.run(main, feed=f, fetch_list=[loss],
                           scope=scope2)[0]) for f in feeds[meta["step"]:]]
    assert rest == want[3:]
