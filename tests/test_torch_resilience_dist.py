"""The port's distributed resilience on the CPU (the counterpart of
``tests/test_resilience_dist.py``): sharded checkpoints (manifest
format_version 2, PT605-PT609) and the cross-replica divergence check.

In one process a sharded save over ``{'dp': 8}`` cuts the state ZeRO-1
would row-shard into 8 shard files (the port's scope holds whole values);
two gloo ranks (``torch_dist_runner``, one launch for the module) each
write their own rows. The 2->1 restore (a two-rank checkpoint resumed by
one process) matches the uninterrupted two-rank run at rtol 1e-5 (the
global batch summed in another order); the 1->2 restore and the two-rank
resume repeat their reference bit for bit."""
import json
import os

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu.unique_name as jun

import paddle_tpu_torch as fluid
import paddle_tpu_torch.unique_name as un
from paddle_tpu_torch import monitor, resilience
from paddle_tpu_torch.resilience import (CheckpointCorruptError,
                                         ReplicaDivergenceError,
                                         fault_plan_guard)
from paddle_tpu_torch.resilience import distributed as rdist

import torch_dist_runner as R

CPU = fluid.CPUPlace()


@pytest.fixture
def flags_guard():
    from paddle_tpu_torch import flags as F

    saved = dict(F._overrides)
    yield fluid.set_flags
    F._overrides.clear()
    F._overrides.update(saved)
    rdist.set_divergence_recovery(None)


class _Session:
    """A small Adam MLP whose moment rows divide 8."""

    def __init__(self):
        with un.guard():
            self.main, self.startup = fluid.Program(), fluid.Program()
            with fluid.program_guard(self.main, self.startup):
                x = fluid.layers.data("x", shape=[16], dtype="float32")
                y = fluid.layers.data("y", shape=[1], dtype="float32")
                h = fluid.layers.fc(x, 16)
                pred = fluid.layers.fc(h, 1)
                self.loss = fluid.layers.mean(
                    fluid.layers.square_error_cost(pred, y))
                fluid.optimizer.Adam(learning_rate=0.01).minimize(self.loss)
        self.exe = fluid.Executor(CPU)
        self.scope = fluid.Scope()
        self.exe.run(self.startup, scope=self.scope)

    def run(self):
        rng = np.random.RandomState(0)
        feed = {"x": rng.rand(8, 16).astype(np.float32),
                "y": rng.rand(8, 1).astype(np.float32)}
        return self.exe.run(self.main, feed=feed, fetch_list=[self.loss],
                            scope=self.scope)

    def save(self, dirname, meta=None, mesh=None):
        fluid.io.save_checkpoint(self.exe, dirname, self.main,
                                 scope=self.scope, meta=meta or {},
                                 mesh=mesh)

    def image(self):
        return {n: self.scope.numpy(n).copy() for n in self.scope.vars}


def _load(s, ck, **kw):
    scope = fluid.Scope()
    meta = fluid.io.load_checkpoint(s.exe, ck, s.main, scope=scope, **kw)
    return meta, scope


def test_sharded_save_restore_roundtrip(tmp_path):
    s = _Session()
    s.run()
    ck = str(tmp_path / "checkpoint_0")
    s.save(ck, meta={"step": 3}, mesh={"dp": 8})
    manifest = resilience.verify_checkpoint(ck)
    assert manifest["format_version"] == 2
    sh = manifest["sharding"]
    assert sh["num_shards"] == 8 and len(sh["shard_files"]) == 8
    assert sh["specs"] and all(k.startswith("moment") for k in sh["specs"])
    assert all(f in manifest["files"] for f in sh["shard_files"])
    before = s.image()
    meta, scope2 = _load(s, ck)
    assert meta["step"] == 3
    for n, v in before.items():
        np.testing.assert_array_equal(scope2.numpy(n), v, err_msg=n)


def test_port_sharded_checkpoint_reads_in_the_jax_package(tmp_path):
    """The format is the JAX package's: its loader reassembles the port's
    shards to the same values."""
    s = _Session()
    s.run()
    ck = str(tmp_path / "checkpoint_0")
    s.save(ck, meta={"step": 1}, mesh={"dp": 4})
    jmain, jstart = jfluid.Program(), jfluid.Program()
    with jun.guard(), jfluid.program_guard(jmain, jstart):
        x = jfluid.layers.data("x", shape=[16], dtype="float32")
        y = jfluid.layers.data("y", shape=[1], dtype="float32")
        h = jfluid.layers.fc(x, 16)
        pred = jfluid.layers.fc(h, 1)
        loss = jfluid.layers.mean(jfluid.layers.square_error_cost(pred, y))
        jfluid.optimizer.Adam(learning_rate=0.01).minimize(loss)
    jexe, jscope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    assert jfluid.io.load_checkpoint(jexe, ck, jmain,
                                     scope=jscope)["step"] == 1
    for n, v in s.image().items():
        np.testing.assert_array_equal(np.asarray(jscope.numpy(n)), v,
                                      err_msg=n)


def test_shard_write_fault_leaves_no_published_checkpoint(tmp_path):
    s = _Session()
    s.run()
    ck = str(tmp_path / "checkpoint_0")
    s.save(ck, meta={"step": 1}, mesh={"dp": 8})
    with fault_plan_guard("shard_write:@4:RuntimeError"):
        with pytest.raises(RuntimeError):
            s.save(str(tmp_path / "checkpoint_1"), meta={"step": 2},
                   mesh={"dp": 8})
    assert [sn for sn, _ in resilience.iter_serials(str(tmp_path))] == [0]
    assert resilience.verify_checkpoint(ck)["format_version"] == 2
    assert [p for p in os.listdir(str(tmp_path)) if ".tmp." in p] == []


def _edit(ck, fn):
    mpath = os.path.join(ck, "manifest.json")
    with open(mpath) as f:
        man = json.load(f)
    fn(man)
    with open(mpath, "w") as f:
        json.dump(man, f)


def _code(ck):
    with pytest.raises(CheckpointCorruptError) as ei:
        resilience.verify_checkpoint(ck)
    return ei.value.code


def test_sharded_corruption_codes(tmp_path):
    s = _Session()
    s.run()
    ck = str(tmp_path / "checkpoint_0")
    mesh = {"dp": 8}

    s.save(ck, mesh=mesh)
    with open(os.path.join(ck, "manifest.json")) as f:
        shard = json.load(f)["sharding"]["shard_files"][3]
    os.remove(os.path.join(ck, shard))          # PT607: declared, absent
    assert _code(ck) == "PT607"

    s.save(ck, mesh=mesh)                        # PT607: never hashed
    _edit(ck, lambda m: m["files"].pop(m["sharding"]["shard_files"][2]))
    assert _code(ck) == "PT607"

    s.save(ck, mesh=mesh)                        # PT603: truncated shard
    with open(os.path.join(ck, shard), "r+b") as f:
        f.truncate(10)
    assert _code(ck) == "PT603"

    s.save(ck, mesh=mesh)                        # PT605: count mismatch
    _edit(ck, lambda m: m["sharding"].update(num_shards=4))
    assert _code(ck) == "PT605"

    s.save(ck, mesh=mesh)                        # PT609: malformed
    _edit(ck, lambda m: m["sharding"].pop("shard_files"))
    assert _code(ck) == "PT609"

    s.save(ck, mesh=mesh)                        # PT606/PT608 at load
    _edit(ck, lambda m: m["vars"][sorted(m["sharding"]["specs"])[0]]
          .update(shape=[3, 3, 3]))
    scope2 = fluid.Scope()
    with pytest.raises(CheckpointCorruptError) as ei:
        fluid.io.load_checkpoint(s.exe, ck, s.main, scope=scope2,
                                 verify=False)
    assert ei.value.code in ("PT606", "PT608")
    assert not scope2.vars, "a failed sharded load must not touch the scope"


def test_recovery_walk_skips_torn_sharded_serial(tmp_path):
    s = _Session()
    s.run()
    s.save(str(tmp_path / "checkpoint_0"), meta={"step": 5}, mesh={"dp": 8})
    s.run()
    ck1 = str(tmp_path / "checkpoint_1")
    s.save(ck1, meta={"step": 9}, mesh={"dp": 8})
    with open(os.path.join(ck1, "manifest.json")) as f:
        os.remove(os.path.join(ck1, json.load(f)["sharding"]
                               ["shard_files"][3]))
    before = monitor.metric_value("trainer_ckpt_fallback_total",
                                  default=0.0, code="PT607")
    meta, serial, skipped = resilience.load_latest_checkpoint(
        s.exe, str(tmp_path), main_program=s.main, scope=fluid.Scope())
    assert meta["step"] == 5 and serial == 0
    assert [k["code"] for k in skipped] == ["PT607"]
    assert monitor.metric_value("trainer_ckpt_fallback_total", default=0.0,
                                code="PT607") == before + 1


def test_divergence_detector_negative_and_positive_names_the_param():
    a = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    assert rdist.replica_divergence_check(
        {"dp": 2}, {"w": [a, a.clone()], "b": [a[0], a[0].clone()]}) == []
    bad = a.clone()
    bad[2, 3] = -0.0 if float(bad[2, 3]) == 0 else bad[2, 3] + 1e-6
    assert rdist.replica_divergence_check(
        {"dp": 2}, {"w": [a, bad], "b": [a[0], a[0].clone()]}) == ["w"]
    # -0.0 and +0.0 compare equal but differ in bits
    z = torch.zeros(3)
    assert rdist.replica_divergence_check(
        {"dp": 2}, {"z": [z, -z]}) == ["z"]
    for dt in (torch.bfloat16, torch.int64, torch.bool, torch.float64):
        t = torch.ones(5).to(dt)
        assert rdist.replica_divergence_check({"dp": 2}, {"t": [t, t]}) \
            == []


def test_divergence_policy_raise_and_restore(flags_guard):
    flags_guard({"FLAGS_replica_divergence_policy": "raise"})
    with pytest.raises(ReplicaDivergenceError) as ei:
        rdist.handle_divergence(["fc_0.w_0", "fc_0.b_0"])
    assert ei.value.param == "fc_0.w_0"
    assert "fc_0.w_0" in str(ei.value)
    flags_guard({"FLAGS_replica_divergence_policy": "restore"})
    calls = []
    rdist.set_divergence_recovery(lambda: calls.append(1) or True)
    rdist.handle_divergence(["fc_0.w_0"])
    assert calls == [1]
    rdist.set_divergence_recovery(lambda: False)   # nothing restorable
    with pytest.raises(ReplicaDivergenceError):
        rdist.handle_divergence(["fc_0.w_0"])
    flags_guard({"FLAGS_replica_divergence_policy": "sometimes"})
    with pytest.raises(ValueError, match="raise or restore"):
        rdist.handle_divergence(["x"])


def test_divergence_never_retried():
    from paddle_tpu_torch.resilience import is_transient

    assert ReplicaDivergenceError.transient is False
    assert not is_transient(ReplicaDivergenceError(["w"]))


def test_names_match_the_jax_package():
    from paddle_tpu import resilience as jres
    from paddle_tpu.resilience import checkpoint as jck
    from paddle_tpu.resilience import distributed as jdist

    from paddle_tpu_torch.resilience import checkpoint as tck

    assert set(jdist.__all__) == set(rdist.__all__)
    assert {k: v for k, v in jck.CKPT_CODES.items()} == tck.CKPT_CODES
    assert set(jres.__all__) <= set(resilience.__all__)
    assert str(ReplicaDivergenceError(["w"])) == \
        str(jdist.ReplicaDivergenceError(["w"]))


# -- two ranks --------------------------------------------------------------

def _single_reference(out):
    """One process, the whole batch: 2 steps, a checkpoint (the 1->2
    restore's source), 2 more steps."""
    main, startup, loss = R.build_mlp(fluid, "adam")
    exe, scope = fluid.Executor(CPU), fluid.Scope()
    exe.run(startup, scope=scope)
    feed = R.mlp_feeds()

    def steps(n):
        return [float(exe.run(main, feed=feed, fetch_list=[loss],
                              scope=scope)[0].reshape(-1)[0])
                for _ in range(n)]
    first = steps(2)
    fluid.io.save_checkpoint(exe, str(out / "ckpt_single"), main,
                             scope=scope, meta={"step": 2})
    return main, startup, loss, first + steps(2)


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    out = tmp_path_factory.mktemp("resilience")
    single = _single_reference(out)
    rc, logs = R.launch(out, ["ckpt", "diverge", "trainer",
                              "trainer_restore"])
    assert rc == 0, logs
    return out, R.results(out), single


def test_two_rank_sharded_checkpoint_resumes_bit_for_bit(launched):
    out, ranks, _ = launched
    man = resilience.verify_checkpoint(str(out / "ckpt_dp"))
    assert man["sharding"]["num_shards"] == 2
    assert man["sharding"]["specs"]
    for r in ranks:
        np.testing.assert_array_equal(r["ckpt/resumed"], r["ckpt/losses"][2:])
        np.testing.assert_array_equal(r["ckpt/w"], r["ckpt/w2"])
        assert int(r["ckpt/meta_step"][0]) == 2
    np.testing.assert_array_equal(ranks[0]["ckpt/losses"],
                                  ranks[1]["ckpt/losses"])


def test_two_rank_checkpoint_restores_on_one(launched):
    """2 -> 1: the shards reassemble; one process on the whole batch
    continues where the two ranks did."""
    out, ranks, (main, startup, loss, _) = launched
    exe, scope = fluid.Executor(CPU), fluid.Scope()
    exe.run(startup, scope=scope)
    assert fluid.io.load_checkpoint(exe, str(out / "ckpt_dp"), main,
                                    scope=scope)["step"] == 2
    m = scope.numpy("moment1_d_fc1.w_0_0")
    assert m.shape == (R.DIM, 32)
    feed = R.mlp_feeds()
    rest = [float(exe.run(main, feed=feed, fetch_list=[loss],
                          scope=scope)[0].reshape(-1)[0]) for _ in range(2)]
    np.testing.assert_allclose(rest, ranks[0]["ckpt/losses"][2:], rtol=1e-5)


def test_one_rank_checkpoint_restores_on_two(launched):
    _, ranks, (_, _, _, single) = launched
    for r in ranks:
        np.testing.assert_allclose(r["ckpt/from_single"], single[2:],
                                   rtol=1e-5)


def test_parallel_step_divergence_check_integration(launched):
    """FLAGS_replica_check_interval=1: a perturbed param on rank 1 raises
    on both ranks naming it (policy raise); under policy restore the
    registered recovery runs once and the next step is clean."""
    _, ranks, _ = launched
    for r in ranks:
        assert str(r["diverge/raised"][0]) == "d_fc2.w_0"
        assert "d_fc2.w_0" in str(r["diverge/message"][0])
        assert int(r["diverge/restored"][0]) == 1
        assert int(r["diverge/clean_after"][0]) == 1
    np.testing.assert_array_equal(ranks[0]["diverge/b_after"],
                                  ranks[1]["diverge/b_after"])


def test_trainer_sharded_checkpoint_resume(launched):
    """contrib.Trainer(parallel=True) with ZeRO-1 and a sharded
    CheckpointConfig: a fresh Trainer given the step-2 checkpoint runs
    steps 3-4 to the uninterrupted run's losses, bit for bit."""
    _, ranks, _ = launched
    for r in ranks:
        assert len(r["trainer/losses"]) == 4
        np.testing.assert_array_equal(r["trainer/resumed"],
                                      r["trainer/losses"][2:])
        assert int(r["trainer/num_shards"][0]) == 2


def test_trainer_divergence_restore_rewinds_step_and_data(launched):
    """Policy restore through contrib.Trainer: the fourth step's check
    restores the step-2 checkpoint; the rolled-back step sends no
    EndStepEvent, the counter takes the checkpoint's step and the data
    rewinds to its cursor, so every later checkpoint records the step and
    cursor of a clean run, and the run ends on the clean run's losses and
    parameters, bit for bit."""
    _, ranks, _ = launched
    for r in ranks:
        g = {k.split("/", 1)[1]: v for k, v in r.items()
             if k.startswith("trainer_restore/")}
        assert g["clean_steps"].tolist() == [0, 1, 2, 3, 4, 5]
        assert g["diverged_steps"].tolist() == [0, 1, 2, 2, 3, 4, 5]
        # [step, epoch, batch] of each checkpoint, the epoch-end one last
        want = [[2, 0, 2], [4, 0, 4], [6, 0, 6], [6, 1, 0]]
        assert g["clean_ckpts"].tolist() == want
        assert g["diverged_ckpts"].tolist() == want
        assert int(g["diverged_final_step"][0]) == 6
        np.testing.assert_array_equal(g["diverged_losses"][3:],
                                      g["clean_losses"][2:])
        np.testing.assert_array_equal(g["diverged_w"], g["clean_w"])
