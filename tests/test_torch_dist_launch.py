"""The port's multi-process data parallelism on the CPU, the counterpart
of ``tests/test_dist_launch.py``: two gloo ranks started by
``paddle_tpu_torch.distributed.launch`` run ``tests/torch_dist_runner.py``
(one launch for the module, a file-store rendezvous in ``tmp_path``, the
call under its own timeout, the process group torn down at exit), each
rank on its half of the global batch.

The reference is the JAX package's ``CompiledProgram`` on a 2-device CPU
mesh over the whole batch, from the same initial scope. Tolerances: the
losses at rtol 2e-4 / atol 1e-5, as the JAX package's launch tests hold
theirs (float32 summed in another order over 10 steps); ZeRO-1 against
AllReduce at the same; the ranks' parameters bit-identical."""
import os

import jax
import numpy as np
import pytest

import paddle_tpu as jfluid

import torch_dist_runner as R

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")


def _jax_mlp(opt, reduce=False):
    main, startup, loss = R.build_mlp(jfluid, opt)
    exe, scope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    exe.run(startup, scope=scope)
    init = {n: np.asarray(scope.numpy(n)) for n in scope.vars}
    bs = jfluid.BuildStrategy()
    if reduce:
        bs.reduce_strategy = jfluid.BuildStrategy.ReduceStrategy.Reduce
    prog = jfluid.CompiledProgram(main).with_data_parallel(
        loss_name=loss.name, build_strategy=bs, places=jax.devices()[:2])
    feed = R.mlp_feeds()
    losses = [float(np.asarray(exe.run(prog, feed=feed, fetch_list=[loss],
                                       scope=scope)[0]).reshape(-1)[0])
              for _ in range(R.STEPS)]
    return init, np.array(losses), np.asarray(scope.numpy("d_fc1.w_0"))


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    out = tmp_path_factory.mktemp("dist")
    ref = {}
    for opt in ("sgd", "adam"):
        init, losses, w = _jax_mlp(opt)
        np.savez(out / f"init_mlp_{opt}.npz", **init)
        ref[opt] = (losses, w)
    ref["zero"] = _jax_mlp("adam", reduce=True)[1:]
    rc, logs = R.launch(out, ["mlp_sgd", "mlp_adam", "mlp_zero",
                              "localsgd", "dygraph"])
    assert rc == 0, logs
    return R.results(out), ref


@pytest.mark.parametrize("case,opt", [("mlp_sgd", "sgd"),
                                      ("mlp_adam", "adam"),
                                      ("mlp_zero", "zero")])
def test_two_process_loss_equality(launched, case, opt):
    ranks, ref = launched
    losses, w = ref[opt]
    for r in ranks:
        np.testing.assert_allclose(r[f"{case}/losses"], losses, rtol=2e-4,
                                   atol=1e-5)
        np.testing.assert_allclose(r[f"{case}/w"], w, rtol=2e-4, atol=1e-5)
    np.testing.assert_array_equal(ranks[0][f"{case}/w"],
                                  ranks[1][f"{case}/w"])
    assert losses[-1] < losses[0]


def test_two_process_zero1_loss_equality(launched):
    """ZeRO-1 trains as AllReduce does, each rank holding half of every
    moment whose rows the ranks divide; together the halves are the
    AllReduce moment."""
    ranks, _ = launched
    for r in ranks:
        np.testing.assert_allclose(r["mlp_zero/losses"],
                                   r["mlp_adam/losses"], rtol=2e-4,
                                   atol=1e-5)
        assert r["mlp_zero/moment"].shape == (R.DIM // 2, 32)
        assert r["mlp_adam/moment"].shape == (R.DIM, 32)
        assert "moment1_d_fc1.w_0_0" in set(r["mlp_zero/sharded"])
        assert "beta1_pow_acc_d_fc1.w_0_0" not in set(r["mlp_zero/sharded"])
    whole = np.concatenate([ranks[0]["mlp_zero/moment"],
                            ranks[1]["mlp_zero/moment"]])
    np.testing.assert_allclose(whole, ranks[0]["mlp_adam/moment"],
                               rtol=2e-4, atol=1e-6)


def test_two_process_dygraph_data_parallel(launched):
    """Each rank's loss is its own; the averaged gradient is the mean of
    two single-process gradients, each on one rank's rows; the ranks'
    weights stay bit-identical."""
    import paddle_tpu_torch as tfluid
    from paddle_tpu_torch import dygraph

    ranks, _ = launched
    rng = np.random.RandomState(42)
    w_true = np.linspace(-1, 1, 12).astype(np.float32).reshape(12, 1)
    xb = rng.rand(R.GLOBAL_BATCH, 12).astype(np.float32)
    yb = (xb @ w_true).astype(np.float32)
    grads = []
    for sl in (slice(0, 4), slice(4, 8)):
        with dygraph.guard(tfluid.CPUPlace()):
            dygraph.seed_parameters(7)
            lin = dygraph.Linear(12, 1)
            x, y = dygraph.to_variable(xb[sl]), dygraph.to_variable(yb[sl])
            loss = dygraph.ops.mean(dygraph.ops.square(lin(x) - y))
            loss.backward()
            grads.append(lin.parameters()[0].gradient())
    for r in ranks:
        np.testing.assert_allclose(r["dygraph/grad0"],
                                   (grads[0] + grads[1]) / 2, rtol=1e-6,
                                   atol=1e-7)
    assert ranks[0]["dygraph/losses"][0] != ranks[1]["dygraph/losses"][0]
    np.testing.assert_array_equal(ranks[0]["dygraph/w"], ranks[1]["dygraph/w"])
    total = ranks[0]["dygraph/losses"] + ranks[1]["dygraph/losses"]
    assert total[-1] < total[0]


def test_two_process_local_sgd(launched):
    """LocalSGD: plain per-rank programs, parameters averaged every 2
    steps; after the last (a sync step) the ranks hold the same params."""
    ranks, _ = launched
    assert list(ranks[0]["localsgd/synced"]) == [False, True] * 5
    np.testing.assert_array_equal(ranks[0]["localsgd/w"],
                                  ranks[1]["localsgd/w"])
    assert not np.array_equal(ranks[0]["localsgd/losses"],
                              ranks[1]["localsgd/losses"])


def test_launcher_propagates_failure(tmp_path):
    """Rank 1 exits 3: the launcher kills rank 0 and returns 3."""
    rc, logs = R.launch(tmp_path, ["fail"], timeout=120)
    assert rc == 3, logs


def test_launcher_refuses_a_missing_script(tmp_path):
    rc, _ = R.launch(tmp_path, ["mlp_sgd"], timeout=120,
                     script="/nonexistent_script.py")
    assert rc != 0


def test_multinode_launch_requires_explicit_port():
    from paddle_tpu_torch.distributed.launch import _parse_args, launch

    args = _parse_args(["--cluster_node_ips", "10.0.0.1,10.0.0.2",
                        "--node_ip", "10.0.0.1", "--backend", "cpu",
                        "dummy.py"])
    with pytest.raises(ValueError, match="started_port"):
        launch(args)


def test_launcher_cli_matches_jax_and_refuses_local_devices():
    from paddle_tpu.distributed.launch import _parse_args as j_parse

    from paddle_tpu_torch.distributed.launch import _parse_args, launch

    argv = ["--nproc_per_node", "2", "--started_port", "6170", "x.py",
            "--flag", "1"]
    j, t = vars(j_parse(argv)), vars(_parse_args(argv))
    for k, v in j.items():
        assert t[k] == v, k
    with pytest.raises(SystemExit):
        _parse_args(["--backend", "tpu", "x.py"])
    with pytest.raises(NotImplementedError, match="one process drives"):
        launch(_parse_args(["--local_devices", "2", "--backend", "cpu",
                            "x.py"]))


def test_parallel_env_contract_and_backend_rule(monkeypatch):
    from paddle_tpu import distributed as jd

    from paddle_tpu_torch import distributed as td

    env = {"PADDLE_TRAINER_ID": "1", "PADDLE_TRAINERS_NUM": "2",
           "PADDLE_CURRENT_ENDPOINT": "127.0.0.1:6171",
           "PADDLE_TRAINER_ENDPOINTS": "127.0.0.1:6170,127.0.0.1:6171",
           "PADDLE_DIST_BACKEND": "cpu", "PADDLE_LOCAL_DEVICES": "1"}
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    j, t = jd.ParallelEnv(), td.ParallelEnv()
    for a in ("trainer_id", "nranks", "current_endpoint",
              "trainer_endpoints", "backend", "local_devices", "rank",
              "world_size"):
        assert getattr(t, a) == getattr(j, a), a
    assert td.collective_backend(t) == "gloo"
    assert type(t.place()).__name__ == "CPUPlace"
    monkeypatch.setenv("PADDLE_DIST_BACKEND", "tpu")
    with pytest.raises(ValueError, match="tpu"):
        td.init_parallel_env()
    monkeypatch.setenv("PADDLE_DIST_BACKEND", "cpu")
    monkeypatch.setenv("PADDLE_LOCAL_DEVICES", "2")
    with pytest.raises(NotImplementedError, match="one card"):
        td.init_parallel_env()
    for k in env:
        monkeypatch.delenv(k)
    assert td.init_parallel_env().nranks == 1     # single process: no-op
    assert not td.is_initialized()
    assert td.all_gather_object(np.arange(3))[0].tolist() == [0, 1, 2]
    tree = {"a": np.ones(2, np.float32)}
    assert td.allgather_mean_tree(tree)["a"] is tree["a"]
    assert set(jd.__all__) <= set(td.__all__)
