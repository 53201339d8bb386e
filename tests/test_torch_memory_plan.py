"""The PyTorch port's memory planner and the executor's release against
the JAX package's planner, on the CPU.

* ``Program.memory_plan`` (``analysis.liveness.memory_plan``) gives the
  same peak bytes, peak op index, bytes by class at the peak, top hot
  spots and dict form as the JAX package's planner on the MLP, BERT-tiny
  (``amp=True``) and ResNet-18 training programs, each built in both
  packages under ``unique_name.guard()``; ``donation_report`` and
  ``safe_donation_set`` are equal. The JAX package runs with 64-bit types
  off and declares the int64 feeds int32, so each port program is planned
  with the JAX program's declared dtypes (the planner is static: it reads
  declarations, never values). Build sites name each package's own
  source lines and are left out of the comparison.
* The executor's release: fetched values and every persistable the step
  writes are bit-identical whether the step's intermediates are fetched
  (held to the end) or released after their last reader; a dead
  intermediate leaves the environment after its last reader; the
  sub-block locals of a ``recompute_segment`` never reach it.
"""
import numpy as np
import pytest

import paddle_tpu.unique_name as jun
from paddle_tpu.analysis import liveness as jliveness
from paddle_tpu.models.bert import BertConfig as JBertConfig
from paddle_tpu.models.bert import build_bert_pretrain as j_bert
from paddle_tpu.models.mlp import build_mnist_mlp as j_mlp
from paddle_tpu.models.resnet import build_resnet as j_resnet

import paddle_tpu_torch as tfluid
import paddle_tpu_torch.unique_name as tun
from paddle_tpu_torch import executor as texecutor
from paddle_tpu_torch.analysis import liveness as tliveness
from paddle_tpu_torch.models.bert import BertConfig as TBertConfig
from paddle_tpu_torch.models.bert import build_bert_pretrain as t_bert
from paddle_tpu_torch.models.mlp import build_mnist_mlp as t_mlp
from paddle_tpu_torch.models.resnet import build_resnet as t_resnet

BUILDERS = {
    "mlp": (lambda: j_mlp(hidden=(64, 32), optimizer="adam"),
            lambda: t_mlp(hidden=(64, 32), optimizer="adam"), 16),
    "bert_tiny_amp": (
        lambda: j_bert(JBertConfig.tiny(), seq_len=32, amp=True),
        lambda: t_bert(TBertConfig.tiny(), seq_len=32, amp=True), 4),
    "resnet18": (
        lambda: j_resnet(18, class_num=10, image_shape=(3, 64, 64)),
        lambda: t_resnet(18, class_num=10, image_shape=(3, 64, 64)), 4),
}


def _build(name):
    jb, tb, batch = BUILDERS[name]
    with jun.guard():
        j = jb()
    with tun.guard():
        t = tb()
    _declare_as(t["main"], j["main"])
    return j, t, batch


def _declare_as(tprog, jprog):
    """Give the port program's vars the JAX program's declared dtypes
    (int64 feeds are int32 there)."""
    for tb, jb in zip(tprog.blocks, jprog.blocks):
        for n, v in tb.vars.items():
            jv = jb.vars.get(n)
            if jv is not None and str(jv.dtype) != v.dtype:
                v.dtype = str(jv.dtype)


def _no_sites(d):
    d = dict(d)
    d.pop("site", None)
    return d


def _fetches(model):
    return [model["loss"].name]


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_memory_plan_matches_jax(name):
    j, t, batch = _build(name)
    feeds = sorted(t["feeds"])
    jp = j["main"].memory_plan(feed_names=feeds, fetch_names=_fetches(j),
                               batch_size=batch)
    tp = t["main"].memory_plan(feed_names=feeds, fetch_names=_fetches(t),
                               batch_size=batch)
    assert tp.peak_bytes == jp.peak_bytes > 0
    assert tp.peak_op_idx == jp.peak_op_idx
    assert tp.by_class_at(tp.peak_op_idx) == jp.by_class_at(jp.peak_op_idx)
    assert tp.timeline == jp.timeline
    assert [_no_sites(e.to_dict()) for e in tp.top_hot_spots(10)] == \
        [_no_sites(e.to_dict()) for e in jp.top_hot_spots(10)]
    td, jd = tp.to_dict(), jp.to_dict()
    td["hot_spots"] = [_no_sites(e) for e in td["hot_spots"]]
    jd["hot_spots"] = [_no_sites(e) for e in jd["hot_spots"]]
    assert td == jd
    assert tp.format().splitlines()[0] == jp.format().splitlines()[0]


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_donation_report_matches_jax(name):
    j, t, _ = _build(name)
    feeds = sorted(t["feeds"])
    jr = jliveness.donation_report(j["main"].global_block, feeds,
                                   _fetches(j))
    tr = tliveness.donation_report(t["main"].global_block, feeds,
                                   _fetches(t))
    assert tr == jr and tr
    assert tliveness.safe_donation_set(
        t["main"].global_block, feeds, _fetches(t)) == \
        jliveness.safe_donation_set(j["main"].global_block, feeds,
                                    _fetches(j))
    # a fetched parameter is refused with the reference's reason
    param = t["main"].all_parameters()[0].name
    tr = tliveness.donation_report(t["main"].global_block, feeds, [param])
    jr = jliveness.donation_report(j["main"].global_block, feeds, [param])
    assert tr[param].startswith("fetched") and tr == jr


def test_per_chip_plan_is_refused():
    with tun.guard():
        t = t_mlp(hidden=(8,))
    with pytest.raises(NotImplementedError, match="sharding_check"):
        t["main"].memory_plan(mesh={"dp": 2})


# ---------------------------------------------------------------------------
# the executor's release
# ---------------------------------------------------------------------------

def _mlp_run(fetch_all, steps=2, scaled=False):
    from paddle_tpu_torch.contrib import mixed_precision

    with tun.guard():
        main, startup = tfluid.Program(), tfluid.Program()
        with tfluid.program_guard(main, startup):
            x = tfluid.layers.data("x", shape=[16], dtype="float32")
            y = tfluid.layers.data("y", shape=[1], dtype="int64")
            h = tfluid.layers.fc(x, 32, act="relu")
            h = tfluid.layers.fc(h, 32, act="relu")
            loss = tfluid.layers.mean(
                tfluid.layers.softmax_with_cross_entropy(
                    tfluid.layers.fc(h, 4), y))
            opt = tfluid.optimizer.Adam(learning_rate=0.01)
            if scaled:
                # the update runs in a conditional_block whose sub-block
                # writes the persistables
                opt = mixed_precision.decorate(
                    opt, init_loss_scaling=8.0,
                    use_dynamic_loss_scaling=True)
            opt.minimize(loss)
    main.random_seed = startup.random_seed = 7
    rng = np.random.RandomState(0)
    feed = {"x": rng.randn(8, 16).astype(np.float32),
            "y": rng.randint(0, 4, (8, 1)).astype(np.int64)}
    blk = main.global_block
    fetch = [loss.name]
    if fetch_all:
        fetch += sorted({n for op in blk.ops for n in op.output_arg_names
                         if blk.has_var(n) and not blk.var(n).persistable
                         and n != loss.name})
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    exe.run(startup, scope=scope)
    # tensors, not numpy: under AMP some intermediates are bfloat16
    outs = [exe.run(main, feed=feed, fetch_list=fetch, scope=scope,
                    return_numpy=False) for _ in range(steps)]
    state = {n: scope.numpy(n) for n in scope.vars}
    return [o[0].numpy() for o in outs], state, len(fetch)


@pytest.mark.parametrize("scaled", [False, True])
def test_release_leaves_fetches_and_persistables_unchanged(scaled):
    held, held_state, n_held = _mlp_run(True, scaled=scaled)
    released, state, n = _mlp_run(False, scaled=scaled)
    assert n_held > 20 and n == 1
    for a, b in zip(held, released):
        assert a.tobytes() == b.tobytes()
    assert sorted(state) == sorted(held_state)
    for k in state:
        assert state[k].tobytes() == held_state[k].tobytes(), k


def _env_trace(monkeypatch):
    """Record the environment's names at each op the executor runs."""
    seen = []
    real = texecutor.lower_op

    def spy(op, env, ctx):
        seen.append((op, set(env)))
        return real(op, env, ctx)

    monkeypatch.setattr(texecutor, "lower_op", spy)
    return seen


def test_a_dead_intermediate_leaves_the_environment(monkeypatch):
    with tun.guard():
        t = t_mlp(hidden=(32, 16), optimizer="adam")
    main, blk = t["main"], t["main"].global_block
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    exe.run(t["startup"], scope=scope)
    rng = np.random.RandomState(1)
    feed = {"img": rng.rand(4, 784).astype(np.float32),
            "label": rng.randint(0, 10, (4, 1)).astype(np.int64)}
    seen = _env_trace(monkeypatch)
    exe.run(main, feed=feed, fetch_list=[t["loss"]], scope=scope)
    assert [op for op, _ in seen] == list(blk.ops)
    live = tliveness.block_liveness(blk, sorted(feed), [t["loss"].name])
    # the first product's output: read by the bias add, then by the
    # bias add's grad op, which is its last reader
    first = blk.ops[0].output("Out")[0]
    last = max(live[first].defs + live[first].uses)
    assert 0 < last < len(blk.ops) - 1
    assert first in seen[last][1]
    assert all(first not in names for _, names in seen[last + 1:])
    # the fetch survives to the end, and so do the persistables read
    # into the step
    assert t["loss"].name in seen[-1][1]
    params = {p.name for p in main.all_parameters()}
    assert params <= seen[-1][1]
    # at the last op the environment holds, of the activations and
    # gradients the step wrote, only the fetch and what the last op reads
    n_ops = len(blk.ops)
    temps = {n for op in blk.ops for n in op.output_arg_names
             if not blk.var(n).persistable}
    needed = {n for n in temps
              if max(live[n].defs + live[n].uses) == n_ops - 1}
    assert seen[-1][1] & temps == needed | {t["loss"].name}
    assert len(needed) < 4 < len(temps)


def test_segment_locals_never_reach_the_environment(monkeypatch):
    with tun.guard():
        main, startup = tfluid.Program(), tfluid.Program()
        with tfluid.program_guard(main, startup):
            x = tfluid.layers.data("x", shape=[16], dtype="float32")
            y = tfluid.layers.data("y", shape=[1], dtype="int64")
            h, ckpts = x, []
            for i in range(4):
                h = tfluid.layers.fc(h, 16, act="relu")
                if i % 2:
                    ckpts.append(h)
            loss = tfluid.layers.mean(
                tfluid.layers.softmax_with_cross_entropy(
                    tfluid.layers.fc(h, 4), y))
            opt = tfluid.optimizer.RecomputeOptimizer(
                tfluid.optimizer.SGD(learning_rate=0.1))
            opt._set_checkpoints(ckpts)
            opt.minimize(loss)
    local = {n for b in main.blocks[1:] for n in b.vars}
    assert local
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    exe.run(startup, scope=scope)
    seen = _env_trace(monkeypatch)
    rng = np.random.RandomState(2)
    exe.run(main, feed={"x": rng.randn(4, 16).astype(np.float32),
                        "y": rng.randint(0, 4, (4, 1)).astype(np.int64)},
            fetch_list=[loss], scope=scope)
    top = [names for op, names in seen if op.block is main.global_block]
    assert len(top) == len(main.global_block.ops)
    assert all(not (names & local) for names in top)
