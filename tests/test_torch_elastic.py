"""``resilience.elastic`` in the PyTorch port against the JAX package's,
on ``tests/test_elastic.py``'s cases, each a parametrised case run in
both packages with the same answer: ``classify_device_error`` (the zoo,
program bugs, the cause chain, the per-element type gate, the context
manager, the injected ``device_lost`` site, retry never absorbing a dead
device), ``plan_rescale`` with its PT61x refusals, ``grad_accum_steps``,
``survivor_devices``, ``format_axes`` and ``DataCursor`` (round trip,
``apply_to_reader`` on a seeded shuffle, ``capture``). The CUDA
runtime's texts for a lost or unusable device classify in the port; a
device-side assert, an illegal address, a launch failure and running
out of memory do not."""
import pytest

from paddle_tpu.resilience import elastic as JE
from paddle_tpu.resilience import faults as jfaults
from paddle_tpu.reader import shuffle as jshuffle

from paddle_tpu_torch.resilience import elastic as TE
from paddle_tpu_torch.resilience import faults as tfaults
from paddle_tpu_torch.resilience import graceful
from paddle_tpu_torch.resilience.retry import call_with_retry
from paddle_tpu_torch.reader import shuffle as tshuffle

PKGS = {"jax": (JE, jfaults, jshuffle), "torch": (TE, tfaults, tshuffle)}


@pytest.fixture(autouse=True)
def _clean():
    yield
    jfaults.clear_plan()
    tfaults.clear_plan()
    graceful.reset_shutdown_state()


def _chained(inner, outer_type=RuntimeError, msg="step dispatch failed"):
    try:
        try:
            raise inner
        except BaseException as e:
            raise outer_type(msg) from e
    except BaseException as outer:
        return outer


def _kind(got):
    return None if got is None else (type(got).__name__, got.site)


ZOO = ["TPU device 3 is halted", "device was lost during execution",
       "chip 2 became unhealthy", "worker preempted by scheduler",
       "ICI link down on slice 0", "failed to connect to worker host-7",
       "NCCL error: unhandled system error"]
NOT_LOST = [ValueError("device lost"), RuntimeError("shape mismatch"),
            RuntimeError("compile failed: invalid HLO"),
            TypeError("device halted")]
CHAINS = {
    "cause": lambda: _chained(RuntimeError("device 5 halted unexpectedly")),
    "exception_wrapper": lambda: _chained(
        RuntimeError("TPU chip 2 became unhealthy"), Exception, "wrapper"),
    "value_error_inside": lambda: _chained(ValueError("device lost"),
                                           Exception, "wrapper"),
}


@pytest.mark.parametrize("msg", ZOO)
def test_classify_the_zoo_as_the_jax_package(msg):
    for site in ("parallel_step", "step"):
        got = {k: E.classify_device_error(RuntimeError(msg), site=site)
               for k, (E, _, _) in PKGS.items()}
        assert _kind(got["torch"]) == _kind(got["jax"]) == \
            ("DeviceLostError", site)
        assert got["torch"].transient is False


@pytest.mark.parametrize("err", NOT_LOST, ids=repr)
def test_program_faults_are_not_device_losses(err):
    for E, _, _ in PKGS.values():
        assert E.classify_device_error(err) is None


@pytest.mark.parametrize("name", sorted(CHAINS))
def test_the_cause_chain_and_type_gate_as_the_jax_package(name):
    got = {k: _kind(E.classify_device_error(CHAINS[name]()))
           for k, (E, _, _) in PKGS.items()}
    assert got["torch"] == got["jax"]
    assert (got["torch"] is None) == (name == "value_error_inside")


def test_the_context_manager_and_pass_through():
    for E, _, _ in PKGS.values():
        with pytest.raises(E.DeviceLostError) as ei:
            with E.device_loss_classification("collective"):
                raise RuntimeError("ICI link down on slice 1")
        assert ei.value.site == "collective"
        assert isinstance(ei.value.__cause__, RuntimeError)
        with pytest.raises(ValueError):
            with E.device_loss_classification("collective"):
                raise ValueError("bad shape")
        orig = E.DeviceLostError("chip gone", site="collective")
        assert E.classify_device_error(orig) is orig


def test_the_injected_site_classifies():
    for E, faults, _ in PKGS.values():
        assert "device_lost" in faults.SITES
        with faults.fault_plan_guard("device_lost:1:RuntimeError"):
            with pytest.raises(RuntimeError) as ei:
                faults.fault_point("device_lost")
        assert isinstance(E.classify_device_error(ei.value),
                          E.DeviceLostError)


def test_retry_never_absorbs_a_device_loss():
    attempts = []

    def dead():
        attempts.append(1)
        raise TE.DeviceLostError("chip gone")

    with pytest.raises(TE.DeviceLostError):
        call_with_retry("step", dead)
    assert len(attempts) == 1


# the CUDA runtime's texts, as torch raises them
CUDA_LOST = {
    "cudaErrorDevicesUnavailable":
        "CUDA error: CUDA-capable device(s) is/are busy or unavailable",
    "cudaErrorNoDevice": "CUDA error: no CUDA-capable device is detected",
    "cudaErrorECCUncorrectable":
        "CUDA error: uncorrectable ECC error encountered",
    "cudaErrorNvlinkUncorrectable":
        "CUDA error: uncorrectable NVLink error was detected during the "
        "execution",
    "cudaErrorCudartUnloading": "CUDA error: driver shutting down",
    "cudaErrorSystemNotReady": "CUDA error: system not yet initialized",
    "NVML_ERROR_GPU_IS_LOST": "NVML: GPU is lost",
}
CUDA_PROGRAM_FAULTS = [
    "CUDA error: device-side assert triggered",
    "CUDA error: an illegal memory access was encountered",
    "CUDA error: unspecified launch failure",
    "CUDA error: the launch timed out and was terminated",
    "CUDA out of memory. Tried to allocate 2.00 GiB. GPU 0 has a total "
    "capacity of 79.10 GiB of which 1.2 GiB is free",
    "CUDA error: invalid argument",
    "CUDA error: misaligned address",
]


@pytest.mark.parametrize("name", sorted(CUDA_LOST))
def test_cuda_device_loss_texts_classify(name):
    assert name in TE._CUDA_DEVICE_LOSS
    got = TE.classify_device_error(RuntimeError(CUDA_LOST[name]),
                                   site="step")
    assert isinstance(got, TE.DeviceLostError) and got.site == "step"
    wrapped = _chained(RuntimeError(CUDA_LOST[name]), Exception, "wrapper")
    assert isinstance(TE.classify_device_error(wrapped), TE.DeviceLostError)


@pytest.mark.parametrize("msg", CUDA_PROGRAM_FAULTS)
def test_cuda_program_faults_do_not_classify(msg):
    assert TE.classify_device_error(RuntimeError(msg)) is None
    assert TE.classify_device_error(_chained(RuntimeError(msg))) is None


PLANS = [
    (({"dp": 8}, 4), {}), (({"dp": 4}, 8), {}), (({"dp": 8}, 7), {}),
    (({"dp": 4, "pp": 2}, 6), {}), (({"dp": 2, "pp": 2, "sp": 2}, 4), {}),
    (({"dp": 4, "pp": 4}, 3), {}), (({"dp": 8}, 1), {"min_dp": 2}),
    (({"dp": 8}, 6), {"global_batch": 16}),
    (({"dp": 8}, 6), {"min_dp": 5, "global_batch": 16}),
    (({}, 3), {}), (({"pp": 2}, 5), {}),
]


def _plan(E, args, kw):
    try:
        return E.plan_rescale(*args, **kw)
    except E.ElasticRescaleError as e:
        assert e.transient is False and e.code in E.ELASTIC_CODES
        return e.code


@pytest.mark.parametrize("args,kw", PLANS, ids=str)
def test_plan_rescale_as_the_jax_package(args, kw):
    assert _plan(TE, args, kw) == _plan(JE, args, kw)


@pytest.mark.parametrize("old,new", [(8, 4), (8, 8), (8, 3), (4, 8),
                                     (0, 0), (5, 2)])
def test_grad_accum_steps_as_the_jax_package(old, new):
    assert TE.grad_accum_steps(old, new) == JE.grad_accum_steps(old, new)


@pytest.mark.parametrize("n,axes", [(8, {"dp": 4}), (3, {"dp": 2, "pp": 2}),
                                    (4, {"dp": 2, "pp": 2}), (2, {})])
def test_survivor_devices_and_format_axes_as_the_jax_package(n, axes):
    def run(E):
        try:
            return E.survivor_devices(list(range(n)), axes)
        except E.ElasticRescaleError as e:
            return e.code

    assert run(TE) == run(JE)
    assert TE.format_axes(axes) == JE.format_axes(axes)
    assert TE.ELASTIC_CODES == JE.ELASTIC_CODES


@pytest.mark.parametrize("d", [
    {"epoch": 2, "batch": 7, "reader_state": {"seed": 5, "epoch": 3}},
    {"epoch": 1, "batch": 0}, None, "junk", {}])
def test_data_cursor_round_trip_as_the_jax_package(d):
    t, j = TE.DataCursor.from_dict(d), JE.DataCursor.from_dict(d)
    assert (t is None) == (j is None)
    if t is not None:
        assert t.to_dict() == j.to_dict()
        assert TE.DataCursor.from_dict(t.to_dict()).to_dict() == \
            t.to_dict()
        assert repr(t) == repr(j)


def test_cursor_capture_and_apply_replay_the_epoch():
    """Mid-epoch capture after the reader advanced past epoch 1; a fresh
    seeded shuffle realigned by ``apply_to_reader`` replays epoch 1 in
    both packages, the same order in each."""
    orders = {}
    for k, (E, _, shuffle) in PKGS.items():
        base = lambda: iter(range(12))  # noqa: E731
        r = shuffle(base, 6, seed=9)
        epoch1 = (list(r()), list(r()))[1]
        cur = E.DataCursor.capture(epoch=1, batch=3, reader=r)
        assert cur.to_dict() == {"epoch": 1, "batch": 3,
                                 "reader_state": {"seed": 9, "epoch": 2}}
        r2 = shuffle(base, 6, seed=9)
        E.DataCursor.from_dict(cur.to_dict()).apply_to_reader(r2)
        orders[k] = list(r2())
        assert orders[k] == epoch1
        plain = E.DataCursor.capture(epoch=0, batch=1, reader=base)
        assert plain.reader_state is None
        plain.apply_to_reader(base)      # a no-op on a plain generator
    assert orders["torch"] == orders["jax"]


def test_capture_survives_a_failing_state_dict():
    class Bad:
        def __call__(self):
            return iter(())

        def state_dict(self):
            raise OSError("cannot read")

    for E, _, _ in PKGS.values():
        cur = E.DataCursor.capture(1, 2, Bad())
        assert cur.to_dict() == {"epoch": 1, "batch": 2}
