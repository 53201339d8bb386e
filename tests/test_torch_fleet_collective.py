"""``incubate.fleet``, the distribute transpiler shims and the
Communicator in the port, against the JAX package's (the counterparts of
``tests/test_transpiler.py`` and the fleet cases of
``tests/test_fleet_deepfm.py``), on the CPU in one process: the role
makers read the same env, the Fleet API trains (ZeRO-1 through
``use_sharding``) to the plain program's losses, the transpiler's modes
make the same decisions, and every refusal's message equals the JAX
package's. Exact equality: nothing here is numeric but the losses, which
one rank computes as the plain Executor does, bit for bit."""
import numpy as np
import pytest

import paddle_tpu as jfluid
from paddle_tpu import communicator as jcomm
from paddle_tpu.incubate.fleet.base import role_maker as jrm
from paddle_tpu.transpiler import distribute_transpiler as jdt

import paddle_tpu_torch as tfluid
import paddle_tpu_torch.unique_name as tun
from paddle_tpu_torch import communicator as tcomm
from paddle_tpu_torch.incubate.fleet.base import role_maker as trm
from paddle_tpu_torch.incubate.fleet.collective import (Fleet,
                                                        DistributedStrategy)
from paddle_tpu_torch.transpiler import distribute_transpiler as tdt

PSERVERS = "127.0.0.1:6174,127.0.0.1:6175"
EPS = PSERVERS.split(",")
CPU = tfluid.CPUPlace()


def _net(fl):
    x = fl.layers.data(name="x", shape=[4], dtype="float32")
    y = fl.layers.data(name="y", shape=[1], dtype="float32")
    pred = fl.layers.fc(input=x, size=1, act=None)
    return fl.layers.mean(fl.layers.square_error_cost(pred, y))


def _feeds(steps=3):
    rng = np.random.RandomState(7)
    return [{"x": rng.rand(8, 4).astype(np.float32),
             "y": rng.rand(8, 1).astype(np.float32)} for _ in range(steps)]


def _run(prog, startup, loss):
    exe, scope = tfluid.Executor(CPU), tfluid.Scope()
    exe.run(startup, scope=scope)
    return [float(exe.run(prog, feed=f, fetch_list=[loss],
                          scope=scope)[0].reshape(-1)[0]) for f in _feeds()]


@pytest.mark.parametrize("cls", ["PaddleCloudRoleMaker",
                                 "UserDefinedRoleMaker"])
def test_role_makers_read_the_same_env(monkeypatch, cls):
    monkeypatch.setenv("PADDLE_TRAINER_ID", "1")
    monkeypatch.setenv("PADDLE_TRAINERS_NUM", "2")
    monkeypatch.setenv("PADDLE_TRAINER_ENDPOINTS",
                       "127.0.0.1:6170,127.0.0.1:6171")
    kw = {} if cls == "PaddleCloudRoleMaker" else dict(
        current_id=1, worker_num=2, worker_endpoints=EPS)
    j, t = getattr(jrm, cls)(**kw), getattr(trm, cls)(**kw)
    j.generate_role()
    t.generate_role()
    for m in ("is_worker", "is_server", "is_first_worker", "worker_index",
              "worker_num", "get_trainer_endpoints"):
        assert getattr(t, m)() == getattr(j, m)(), m
    assert set(jrm.__all__) == set(trm.__all__)


@pytest.mark.parametrize("sharding", [False, True])
def test_fleet_collective_api_trains_as_the_plain_program(sharding):
    main, startup = tfluid.Program(), tfluid.Program()
    with tun.guard(), tfluid.program_guard(main, startup):
        loss = _net(tfluid)
    f = Fleet()
    with pytest.raises(RuntimeError, match="fleet.init"):
        f.worker_num()
    f.init(trm.PaddleCloudRoleMaker(is_collective=True))
    assert f.is_first_worker() and f.worker_index() == 0
    assert f.worker_num() == 1 and f.is_worker()
    strategy = DistributedStrategy()
    strategy.use_sharding = sharding
    with pytest.raises(RuntimeError, match="minimize"):
        f.main_program
    with tfluid.program_guard(main, startup):
        f.distributed_optimizer(tfluid.optimizer.Adam(0.01),
                                strategy).minimize(loss)
    compiled = f.main_program
    assert isinstance(compiled, tfluid.CompiledProgram)
    assert compiled._build_strategy.reduce_strategy == int(sharding)
    ref = _run(main, startup, loss)
    assert _run(compiled, startup, loss) == ref


def test_pserver_sync_script_end_to_end():
    with tfluid.program_guard(tfluid.Program(), tfluid.Program()):
        loss = _net(tfluid)
        tfluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
        main, startup = (tfluid.default_main_program(),
                         tfluid.default_startup_program())
        plain = _run(main, startup, loss)
        t = tfluid.DistributeTranspiler()
        t.transpile(trainer_id=0, pservers=PSERVERS, trainers=2,
                    sync_mode=True, program=main, startup_program=startup)
        assert t.get_trainer_program() is main
        assert _run(t.get_trainer_program(), startup, loss) == plain
        exe = tfluid.Executor(CPU)
        for ep in EPS:
            pmain, pstart = t.get_pserver_programs(ep)
            assert exe.run(pstart) == [] and exe.run(pmain) == []
        assert set(t.param_grad_ep_mapping) == set(EPS)
        with pytest.raises(ValueError):
            t.get_pserver_program("10.0.0.1:9999")


def _refusal(pkg, fn):
    with pytest.raises(NotImplementedError) as ei:
        fn(pkg)
    return str(ei.value)


@pytest.mark.parametrize("mode", ["async", "geo", "dc_asgd"])
def test_async_geo_and_dc_asgd_raise_the_jax_message(mode):
    def go(fl):
        with fl.program_guard(fl.Program(), fl.Program()):
            loss = _net(fl)
            fl.optimizer.SGD(learning_rate=0.1).minimize(loss)
            cfg = fl.DistributeTranspilerConfig()
            if mode == "geo":
                cfg.geo_sgd_mode = True
            if mode == "dc_asgd":
                cfg.enable_dc_asgd = True
            fl.DistributeTranspiler(config=cfg).transpile(
                trainer_id=0, pservers=PSERVERS, trainers=2,
                sync_mode=mode != "async")
    assert _refusal(tfluid, go) == _refusal(jfluid, go)


@pytest.mark.parametrize("mode", ["nccl2", "collective"])
def test_collective_modes_record_endpoints(mode):
    for fl in (tfluid, jfluid):
        with fl.program_guard(fl.Program(), fl.Program()):
            loss = _net(fl)
            cfg = fl.DistributeTranspilerConfig()
            cfg.mode = mode
            t = fl.DistributeTranspiler(config=cfg)
            eps = "10.0.0.1:6170,10.0.0.2:6170"
            t.transpile(trainer_id=0, trainers=eps, sync_mode=False,
                        current_endpoint="10.0.0.1:6170")
            assert t.trainer_endpoints == eps.split(",")
            assert t.trainer_num == 2
            assert t.get_trainer_program() is fl.default_main_program()
            del loss
    cfg = tfluid.DistributeTranspilerConfig()
    cfg.mode = "collective"
    with pytest.raises(ValueError, match="endpoint string"):
        tfluid.DistributeTranspiler(config=cfg).transpile(trainer_id=0,
                                                          trainers=2)


def test_geo_transpiler_and_communicator_raise_the_jax_messages():
    from paddle_tpu.transpiler import GeoSgdTranspiler as JGeo

    from paddle_tpu_torch.transpiler import GeoSgdTranspiler as TGeo

    assert _refusal(None, lambda _: TGeo()) == _refusal(None,
                                                        lambda _: JGeo())
    assert _refusal(None, lambda _: tcomm.Communicator(None)) == \
        _refusal(None, lambda _: jcomm.Communicator(None))
    assert tdt._ASYNC_MIGRATION_MSG == jdt._ASYNC_MIGRATION_MSG
    assert tdt._GEO_MIGRATION_MSG == jdt._GEO_MIGRATION_MSG


def test_dispatchers_place_as_the_jax_package():
    from paddle_tpu.transpiler import HashName as JH, RoundRobin as JR

    from paddle_tpu_torch.transpiler import HashName as TH, RoundRobin as TR

    names = [f"fc_{i}.w_0" for i in range(7)]
    assert TH(EPS).dispatch(names) == JH(EPS).dispatch(names)
    assert TR(EPS).dispatch(names) == JR(EPS).dispatch(names)


def test_top_level_reexports_and_fs():
    from paddle_tpu_torch.incubate.fleet.utils import fs

    for name in ("DistributeTranspiler", "DistributeTranspilerConfig",
                 "memory_optimize", "release_memory", "CompiledProgram",
                 "BuildStrategy", "ExecutionStrategy", "parallel",
                 "distributed"):
        assert hasattr(tfluid, name), name
    assert tfluid.transpiler.DistributeTranspiler is \
        tfluid.DistributeTranspiler
    with pytest.raises(RuntimeError, match="hadoop"):
        fs.HDFSClient(hadoop_home="/nonexistent").ls_dir("/")
