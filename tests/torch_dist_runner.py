"""Rank script for the port's multi-process tests (the counterpart of
``tests/dist_runner.py`` and ``tests/dygraph_dist_runner.py``).

    python -m paddle_tpu_torch.distributed.launch --nproc_per_node 2 \\
        --backend cpu --rendezvous_file F tests/torch_dist_runner.py \\
        OUT_DIR CASE[,CASE...]

Each rank runs the named cases in order on its slice of the same global
batch and writes what they report to ``OUT_DIR/rank<r>.npz`` (keys
``<case>/<name>``). Inputs a case needs from the test process (an initial
scope, a feed, a checkpoint) are read from ``OUT_DIR``. The builders are
shared with the tests, which build the same programs in the JAX package.
The process group is torn down at exit (``distributed``'s atexit hook).
"""
import json
import os
import sys

import numpy as np

GLOBAL_BATCH, STEPS, DIM = 8, 10, 16
BERT_SEQ, BERT_BATCH, BERT_STEPS = 16, 4, 3
BN_BATCH, BN_STEPS = 8, 3


# -- builders (shared with the tests: `fluid` is either package) -----------

def build_mlp(fluid, opt="sgd"):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data("x", shape=[DIM], dtype="float32")
        y = fluid.layers.data("y", shape=[1], dtype="float32")
        h = fluid.layers.fc(x, 32, act="relu", name="d_fc1")
        pred = fluid.layers.fc(h, 1, name="d_fc2")
        loss = fluid.layers.mean(fluid.layers.square_error_cost(pred, y))
        if opt == "adam":
            fluid.optimizer.Adam(learning_rate=0.02).minimize(loss)
        elif opt == "sgd":
            fluid.optimizer.SGD(learning_rate=0.02).minimize(loss)
    main.random_seed = 31
    startup.random_seed = 31
    return main, startup, loss


def mlp_feeds():
    rng = np.random.RandomState(42)
    w_true = np.linspace(-1, 1, DIM).astype(np.float32).reshape(DIM, 1)
    xb = rng.rand(GLOBAL_BATCH, DIM).astype(np.float32)
    return {"x": xb, "y": np.tanh(xb @ w_true).astype(np.float32)}


def build_bn_net(fluid):
    """conv2d -> batch_norm(relu) -> pool2d -> fc -> softmax CE -> mean,
    Momentum: training-mode batch_norm couples the batch."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        img = fluid.layers.data("img", shape=[3, 8, 8], dtype="float32")
        label = fluid.layers.data("label", shape=[1], dtype="int64")
        c = fluid.layers.conv2d(img, 4, 3, padding=1, name="bn_conv")
        b = fluid.layers.batch_norm(c, act="relu", name="bn_bn")
        p = fluid.layers.pool2d(b, pool_size=2, pool_type="max",
                                pool_stride=2)
        logits = fluid.layers.fc(p, 5, name="bn_fc")
        loss = fluid.layers.mean(
            fluid.layers.softmax_with_cross_entropy(logits, label))
        fluid.optimizer.Momentum(learning_rate=0.1,
                                 momentum=0.9).minimize(loss)
    main.random_seed = 5
    startup.random_seed = 5
    return main, startup, loss


def bn_feeds(seed=3):
    rng = np.random.RandomState(seed)
    return {"img": rng.randn(BN_BATCH, 3, 8, 8).astype(np.float32),
            "label": rng.randint(0, 5, (BN_BATCH, 1)).astype(np.int64)}


def bert_cfg(cls, dropout=0.0):
    import dataclasses

    return dataclasses.replace(cls.tiny(), hidden_dropout=dropout,
                               attention_dropout=dropout)


def bert_feeds(seed=0, batch=BERT_BATCH, seq=BERT_SEQ):
    """Rows 0-1 mask 2 and 3 tokens, rows 2-3 mask 5 and 6: two ranks'
    shards hold different masked counts."""
    rng = np.random.RandomState(seed)
    lens = np.array([[seq], [seq - 4], [seq - 6], [seq]])[:batch]
    labels = np.full((batch, seq), -100, np.int64)
    for r, k in enumerate([2, 3, 5, 6][:batch]):
        pos = rng.choice(seq, k, replace=False)
        labels[r, pos] = rng.randint(0, 1024, k)
    return {
        "src_ids": rng.randint(0, 1024, (batch, seq)).astype(np.int64),
        "pos_ids": np.tile(np.arange(seq), (batch, 1)).astype(np.int64),
        "sent_ids": (np.arange(seq)[None] >= seq // 2).astype(np.int64)
        .repeat(batch, 0),
        "input_mask": (np.arange(seq)[None] < lens).astype(np.float32),
        "mask_label": labels,
        "next_sent_label": rng.randint(0, 2, (batch, 1)).astype(np.int64)}


def param_grads(program):
    """The trainable parameters' gradient names (the batch-norm running
    statistics get none)."""
    return [p.name + "@GRAD" for p in program.all_parameters()
            if p.name + "@GRAD" in program.global_block.vars]


# -- test side: launch the ranks and read what they wrote -----------------

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def launch(out_dir, cases, nproc=2, timeout=240, script=None,
           backend="cpu"):
    """Run ``cases`` on ``nproc`` ranks through the port's launcher (gloo
    on the CPU by default; ``backend="gpu"``: rank r on card r modulo the
    cards), the rendezvous in a file under ``out_dir`` (no port to race
    another test process for), the call under its own ``timeout``.
    Returns ``(returncode, combined worker logs)``."""
    import subprocess

    env = {k: v for k, v in os.environ.items()
           if not k.startswith("PADDLE_")}
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    logs = os.path.join(out_dir, "logs")
    cmd = [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
           "--nproc_per_node", str(nproc), "--backend", backend,
           "--rendezvous_file", os.path.join(out_dir, "rendezvous"),
           "--log_dir", logs, script or os.path.abspath(__file__),
           str(out_dir), ",".join(cases)]
    r = subprocess.run(cmd, env=env, capture_output=True, text=True,
                       timeout=timeout)
    text = r.stdout + r.stderr
    for n in range(nproc):
        path = os.path.join(logs, f"workerlog.{n}")
        if os.path.exists(path):
            with open(path) as f:
                text += f"\n--- workerlog.{n}\n" + f.read()
    return r.returncode, text


def results(out_dir, nproc=2):
    """Each rank's reported values: a list of dicts, by rank."""
    out = []
    for r in range(nproc):
        with np.load(os.path.join(out_dir, f"rank{r}.npz")) as z:
            out.append({k: z[k] for k in z.files})
    return out


# -- rank side --------------------------------------------------------------

class Ctx:
    def __init__(self, out):
        from paddle_tpu_torch import distributed as dist

        self.out = out
        self.env = dist.init_parallel_env()
        self.rank, self.world = self.env.rank, self.env.world_size
        self.place = self.env.place()

    def rows(self, n):
        k = n // self.world
        return slice(self.rank * k, (self.rank + 1) * k)

    def shard(self, feed):
        return {k: v[self.rows(len(v))] for k, v in feed.items()}

    def load(self, name):
        with np.load(os.path.join(self.out, name)) as z:
            return {k: z[k] for k in z.files}


def _compiled(fluid, main, loss, zero=False):
    bs = fluid.BuildStrategy()
    if zero:
        bs.reduce_strategy = fluid.BuildStrategy.ReduceStrategy.Reduce
    return fluid.CompiledProgram(main).with_data_parallel(
        loss_name=loss.name, build_strategy=bs)


def _mlp_run(ctx, opt, zero=False):
    """From the test's initial scope (``init_mlp_<opt>.npz``)."""
    import paddle_tpu_torch as fluid

    main, startup, loss = build_mlp(fluid, opt)
    exe = fluid.Executor(ctx.place)
    scope = fluid.Scope()
    _plant(fluid, scope, ctx.load(f"init_mlp_{opt}.npz"), ctx.place, [main])
    prog = _compiled(fluid, main, loss, zero)
    feed = ctx.shard(mlp_feeds())
    losses = [float(exe.run(prog, feed=feed, fetch_list=[loss],
                            scope=scope)[0].reshape(-1)[0])
              for _ in range(STEPS)]
    return main, scope, np.array(losses)


def case_mlp_sgd(ctx):
    _, scope, losses = _mlp_run(ctx, "sgd")
    return {"losses": losses, "w": scope.numpy("d_fc1.w_0")}


def case_mlp_adam(ctx):
    _, scope, losses = _mlp_run(ctx, "adam")
    return {"losses": losses, "w": scope.numpy("d_fc1.w_0"),
            "moment": scope.numpy("moment1_d_fc1.w_0_0")}


def case_mlp_zero(ctx):
    _, scope, losses = _mlp_run(ctx, "adam", zero=True)
    return {"losses": losses, "w": scope.numpy("d_fc1.w_0"),
            "moment": scope.numpy("moment1_d_fc1.w_0_0"),
            "sharded": np.array(sorted(getattr(scope, "_dp_shards", {})))}


def case_localsgd(ctx):
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.incubate.fleet.collective import LocalSGDSync

    main, startup, loss = build_mlp(fluid, "sgd")
    exe = fluid.Executor(ctx.place)
    scope = fluid.Scope()
    _plant(fluid, scope, ctx.load("init_mlp_sgd.npz"), ctx.place, [main])
    sync = LocalSGDSync(main, k_steps=2)
    feed = ctx.shard(mlp_feeds())
    losses, synced = [], []
    for _ in range(STEPS):
        losses.append(float(exe.run(main, feed=feed, fetch_list=[loss],
                                    scope=scope)[0].reshape(-1)[0]))
        synced.append(sync.step(scope))
    return {"losses": np.array(losses), "synced": np.array(synced),
            "w": scope.numpy("d_fc1.w_0")}


def case_dygraph(ctx):
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import dygraph

    rng = np.random.RandomState(42)
    w_true = np.linspace(-1, 1, 12).astype(np.float32).reshape(12, 1)
    xb = rng.rand(GLOBAL_BATCH, 12).astype(np.float32)
    yb = (xb @ w_true).astype(np.float32)
    sl = ctx.rows(GLOBAL_BATCH)
    with dygraph.guard(ctx.place):
        dygraph.prepare_context()
        dygraph.seed_parameters(7)
        model = dygraph.DataParallel(dygraph.Linear(12, 1))
        opt = fluid.optimizer.SGD(learning_rate=0.1)
        x, y = dygraph.to_variable(xb[sl]), dygraph.to_variable(yb[sl])
        losses, grads = [], []
        for _ in range(6):
            loss = dygraph.ops.mean(dygraph.ops.square(model(x) - y))
            loss = model.scale_loss(loss)
            loss.backward()
            model.apply_collective_grads()
            grads.append(model.parameters()[0].gradient().copy())
            opt.minimize(loss, parameter_list=model.parameters())
            model.clear_gradients()
            losses.append(float(loss.numpy()))
        w = model.state_dict()["weight"]
    return {"losses": np.array(losses), "grad0": grads[0],
            "w": np.asarray(w)}


def _plant(fluid, scope, arrays, place, programs):
    from paddle_tpu_torch.interop import scope_from_numpy

    scope_from_numpy(arrays, scope, place, programs=programs)


def _grad_run(ctx, main, loss, init, feed, steps, zero=False):
    import paddle_tpu_torch as fluid

    exe = fluid.Executor(ctx.place)
    scope = fluid.Scope()
    _plant(fluid, scope, init, ctx.place, [main])
    prog = _compiled(fluid, main, loss, zero)
    names = param_grads(main)
    shard = ctx.shard(feed)
    out = exe.run(prog, feed=shard, fetch_list=[loss.name] + names,
                  scope=scope)
    res = {"grad/" + n: v for n, v in zip(names, out[1:])}
    losses = [float(out[0].reshape(-1)[0])]
    for _ in range(steps - 1):
        losses.append(float(exe.run(prog, feed=shard, fetch_list=[loss],
                                    scope=scope)[0].reshape(-1)[0]))
    res["losses"] = np.array(losses)
    for p in main.all_parameters():
        res["param/" + p.name] = scope.numpy(p.name)
    return res


def case_bert(ctx):
    import paddle_tpu_torch as fluid
    import paddle_tpu_torch.unique_name as un
    from paddle_tpu_torch.models.bert import BertConfig, build_bert_pretrain

    with un.guard():
        m = build_bert_pretrain(bert_cfg(BertConfig), seq_len=BERT_SEQ)
    feed = bert_feeds()
    shard = ctx.shard(feed)
    res = _grad_run(ctx, m["main"], m["loss"], ctx.load("init_bert.npz"),
                    feed, BERT_STEPS)
    res["masked"] = np.array([(shard["mask_label"] != -100).sum()])
    return res


def case_bn(ctx):
    import paddle_tpu_torch as fluid

    main, _, loss = build_bn_net(fluid)
    return _grad_run(ctx, main, loss, ctx.load("init_bn.npz"), bn_feeds(),
                     BN_STEPS)


def case_dropout(ctx):
    """BERT-tiny at dropout 0.1, both ranks fed the SAME rows: the
    gathered dropout and attention outputs differ between the ranks'
    halves; a second run from the same scope repeats bit for bit."""
    import paddle_tpu_torch as fluid
    import paddle_tpu_torch.unique_name as un
    from paddle_tpu_torch.models.bert import BertConfig, build_bert_pretrain

    with un.guard():
        m = build_bert_pretrain(bert_cfg(BertConfig, 0.1), seq_len=BERT_SEQ)
    main, loss = m["main"], m["loss"]
    ops = main.global_block.ops
    drop = next(op.output("Out")[0] for op in ops if op.type == "dropout")
    attn = next(op.output("Out")[0] for op in ops
                if op.type == "fused_multihead_attention")
    feed = {k: v[:2] for k, v in bert_feeds().items()}
    init = ctx.load("init_bert.npz")
    runs = []
    for _ in range(2):
        exe = fluid.Executor(ctx.place)
        scope = fluid.Scope()
        _plant(fluid, scope, init, ctx.place, [main])
        prog = _compiled(fluid, main, loss)
        runs.append(exe.run(prog, feed=feed, fetch_list=[drop, attn, loss],
                            scope=scope))
    return {"drop": runs[0][0], "attn": runs[0][1], "drop2": runs[1][0],
            "attn2": runs[1][1], "loss": runs[0][2], "loss2": runs[1][2]}


def case_ckpt(ctx):
    """ZeRO-1 Adam MLP: a sharded checkpoint after step 2 resumes bit for
    bit in a fresh scope; the test restores it on one rank too. Then a
    checkpoint the test saved on one rank (``ckpt_single``) resumes on
    these two."""
    import paddle_tpu_torch as fluid

    main, startup, loss = build_mlp(fluid, "adam")
    feed = ctx.shard(mlp_feeds())
    mesh = {"dp": ctx.world}

    def steps(exe, prog, scope, n):
        return [float(exe.run(prog, feed=feed, fetch_list=[loss],
                              scope=scope)[0].reshape(-1)[0])
                for _ in range(n)]

    exe = fluid.Executor(ctx.place)
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    prog = _compiled(fluid, main, loss, zero=True)
    first = steps(exe, prog, scope, 2)
    path = os.path.join(ctx.out, "ckpt_dp")
    fluid.io.save_checkpoint(exe, path, main, scope=scope,
                             meta={"step": 2}, mesh=mesh)
    rest = steps(exe, prog, scope, 2)
    exe2 = fluid.Executor(ctx.place)
    scope2 = fluid.Scope()
    exe2.run(startup, scope=scope2)
    meta = fluid.io.load_checkpoint(exe2, path, main, scope=scope2)
    resumed = steps(exe2, _compiled(fluid, main, loss, zero=True), scope2, 2)
    res = {"losses": np.array(first + rest), "resumed": np.array(resumed),
           "meta_step": np.array([meta["step"]]),
           "w": scope.numpy("d_fc1.w_0"), "w2": scope2.numpy("d_fc1.w_0")}
    single = os.path.join(ctx.out, "ckpt_single")
    if os.path.isdir(single):
        exe3 = fluid.Executor(ctx.place)
        scope3 = fluid.Scope()
        exe3.run(startup, scope=scope3)
        fluid.io.load_checkpoint(exe3, single, main, scope=scope3)
        res["from_single"] = np.array(
            steps(exe3, _compiled(fluid, main, loss, zero=True), scope3, 2))
    return res


def case_diverge(ctx):
    """FLAGS_replica_check_interval=1: clean steps pass; a perturbed
    param on rank 1 raises naming it (policy raise) on every rank, and is
    restored by the registered recovery (policy restore)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.resilience import distributed as rdist

    main, startup, loss = build_mlp(fluid, "sgd")
    feed = ctx.shard(mlp_feeds())
    exe = fluid.Executor(ctx.place)
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    prog = _compiled(fluid, main, loss)
    fluid.set_flags({"FLAGS_replica_check_interval": 1,
                     "FLAGS_replica_divergence_policy": "raise"})
    res = {}
    try:
        exe.run(prog, feed=feed, fetch_list=[loss], scope=scope)
        good = {n: scope.find_var(n).clone() for n in
                ("d_fc1.w_0", "d_fc1.b_0", "d_fc2.w_0", "d_fc2.b_0")}
        if ctx.rank == 1:
            scope.find_var("d_fc2.w_0").add_(1e-3)
        try:
            exe.run(prog, feed=feed, fetch_list=[loss], scope=scope)
            res["raised"] = np.array([""])
        except rdist.ReplicaDivergenceError as e:
            res["raised"] = np.array([e.param])
            res["message"] = np.array([str(e)])
        for n, v in good.items():
            scope.set_var(n, v.clone())
        if ctx.rank == 1:
            scope.find_var("d_fc1.b_0").add_(1.0)
        calls = []

        def recover():
            calls.append(1)
            for n, v in good.items():
                scope.set_var(n, v.clone())
            return True

        fluid.set_flags({"FLAGS_replica_divergence_policy": "restore"})
        rdist.set_divergence_recovery(recover)
        exe.run(prog, feed=feed, fetch_list=[loss], scope=scope)
        res["restored"] = np.array([len(calls)])
        res["b_after"] = scope.numpy("d_fc1.b_0")
        rdist.set_divergence_recovery(None)
        exe.run(prog, feed=feed, fetch_list=[loss], scope=scope)
        res["clean_after"] = np.array([1])
    finally:
        fluid.set_flags({"FLAGS_replica_check_interval": 0,
                         "FLAGS_replica_divergence_policy": "raise"})
    return res


def case_trainer(ctx):
    """contrib.Trainer(parallel=True, ZeRO-1) with
    CheckpointConfig(sharded=True): 4 steps straight with a sharded
    checkpoint every 2; a fresh Trainer given only the step-2 checkpoint
    resumes and runs steps 3-4."""
    import shutil

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.contrib.trainer import (CheckpointConfig,
                                                  EndStepEvent, Trainer)

    feed = mlp_feeds()
    sl = ctx.rows(GLOBAL_BATCH)

    def train_func():
        x = fluid.layers.data("x", shape=[DIM], dtype="float32")
        y = fluid.layers.data("y", shape=[1], dtype="float32")
        h = fluid.layers.fc(x, 32, act="relu", name="d_fc1")
        pred = fluid.layers.fc(h, 1, name="d_fc2")
        return fluid.layers.mean(fluid.layers.square_error_cost(pred, y))

    def reader():
        for _ in range(4):
            yield list(zip(feed["x"][sl], feed["y"][sl]))

    def run(ckpt_dir):
        bs = fluid.BuildStrategy()
        bs.reduce_strategy = fluid.BuildStrategy.ReduceStrategy.Reduce
        with fluid.unique_name.guard():
            t = Trainer(train_func, lambda: fluid.optimizer.Adam(0.02),
                        place=ctx.place, parallel=True, build_strategy=bs,
                        checkpoint_config=CheckpointConfig(
                            ckpt_dir, max_num_checkpoints=0,
                            step_interval=2, sharded=True))
        losses = []
        t.train(1, lambda ev: losses.append(ev.metrics[0])
                if isinstance(ev, EndStepEvent) else None,
                reader, ["x", "y"])
        return losses

    dir_a = os.path.join(ctx.out, "trainer_a")
    dir_b = os.path.join(ctx.out, "trainer_b")
    straight = run(dir_a)
    if ctx.rank == 0:
        shutil.copytree(os.path.join(dir_a, "checkpoint_0"),
                        os.path.join(dir_b, "checkpoint_0"))
    dist.barrier()
    resumed = run(dir_b)
    with open(os.path.join(dir_a, "checkpoint_1", "manifest.json")) as f:
        shards = json.load(f)["sharding"]["num_shards"]
    return {"losses": np.array(straight), "resumed": np.array(resumed),
            "num_shards": np.array([shards])}


def case_trainer_restore(ctx):
    """contrib.Trainer(parallel=True, sharded checkpoints every 2 steps;
    AllReduce, as ZeRO-1's gather would heal the perturbed rows) under
    FLAGS_replica_check_interval=1 and policy restore, over six
    different batches: in one run rank 1 perturbs a parameter after
    the third step, so the fourth step's check restores the step-2
    checkpoint; a clean run beside it. Each run reports its EndStepEvent
    steps and losses, each checkpoint's step and data cursor, and the
    final parameters."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.contrib.trainer import (CheckpointConfig,
                                                  EndStepEvent, Trainer)

    feed = mlp_feeds()
    sl = ctx.rows(GLOBAL_BATCH)

    def train_func():
        x = fluid.layers.data("x", shape=[DIM], dtype="float32")
        y = fluid.layers.data("y", shape=[1], dtype="float32")
        h = fluid.layers.fc(x, 32, act="relu", name="d_fc1")
        pred = fluid.layers.fc(h, 1, name="d_fc2")
        return fluid.layers.mean(fluid.layers.square_error_cost(pred, y))

    def reader():
        for i in range(6):
            xs, ys = (np.roll(feed[k], i, axis=0)[sl] for k in ("x", "y"))
            yield list(zip(xs, ys))

    def run(ckpt_dir, perturb):
        with fluid.unique_name.guard():
            t = Trainer(train_func, lambda: fluid.optimizer.Adam(0.02),
                        place=ctx.place, parallel=True,
                        checkpoint_config=CheckpointConfig(
                            ckpt_dir, max_num_checkpoints=0,
                            step_interval=2, sharded=True))
        steps, losses, left = [], [], [perturb]

        def handler(ev):
            if not isinstance(ev, EndStepEvent):
                return
            steps.append(ev.step)
            losses.append(ev.metrics[0])
            if ev.step == 2 and left[0]:
                left[0] = False
                if ctx.rank == 1:
                    t.scope.find_var("d_fc2.w_0").add_(1e-3)

        t.train(1, handler, reader, ["x", "y"])
        ckpts = []
        for serial in sorted(int(d.split("_")[1])
                             for d in os.listdir(ckpt_dir)):
            with open(os.path.join(ckpt_dir, f"checkpoint_{serial}",
                                   "meta.json")) as f:
                meta = json.load(f)
            cur = meta["data_cursor"]
            ckpts.append([meta["step"], cur["epoch"], cur["batch"]])
        return {"steps": np.array(steps), "losses": np.array(losses),
                "ckpts": np.array(ckpts), "final_step": np.array([t._step]),
                "w": t.scope.numpy("d_fc2.w_0")}

    fluid.set_flags({"FLAGS_replica_check_interval": 1,
                     "FLAGS_replica_divergence_policy": "restore"})
    try:
        res = {}
        for tag, perturb in (("clean", False), ("diverged", True)):
            for k, v in run(os.path.join(ctx.out, "restore_" + tag),
                            perturb).items():
                res[f"{tag}_{k}"] = v
    finally:
        fluid.set_flags({"FLAGS_replica_check_interval": 0,
                         "FLAGS_replica_divergence_policy": "raise"})
    return res


def case_checks(ctx):
    """The executor's checks on the parallel step: FLAGS_numerics_witness
    records one step's vars; then, under FLAGS_check_nan_inf (policy
    raise), a NaN fed on rank 1 trips both ranks, each restoring its
    scope."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.monitor import numwitness

    main, startup, loss = build_mlp(fluid, "sgd")
    exe = fluid.Executor(ctx.place)
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    prog = _compiled(fluid, main, loss)
    feed = ctx.shard(mlp_feeds())
    numwitness.reset_numerics_witness()
    fluid.set_flags({"FLAGS_numerics_witness": 1})
    try:
        exe.run(prog, feed=feed, fetch_list=[loss], scope=scope)
    finally:
        fluid.set_flags({"FLAGS_numerics_witness": 0})
    witnessed = sorted(numwitness.numerics_witness_vars())
    before = scope.numpy("d_fc1.w_0").copy()
    if ctx.rank == 1:
        feed["x"] = feed["x"].copy()
        feed["x"][0, 0] = np.nan
    fluid.set_flags({"FLAGS_check_nan_inf": 1})
    try:
        exe.run(prog, feed=feed, fetch_list=[loss], scope=scope)
        message = ""
    except FloatingPointError as e:
        message = str(e)
    finally:
        fluid.set_flags({"FLAGS_check_nan_inf": 0})
    return {"witnessed": np.array(witnessed), "message": np.array([message]),
            "restored": np.array([np.array_equal(
                scope.numpy("d_fc1.w_0"), before)])}


def case_collectives(ctx):
    """The collective helpers on this rank's device over the backend the
    rule picked: all-reduce, broadcast, all-gather (bit for bit, NaN
    payloads and -0.0 included) and reduce-scatter."""
    import torch

    from paddle_tpu_torch import distributed as dist

    dev = ctx.place.torch_device()
    r = ctx.rank
    t = torch.full((3, 2), float(r + 1), device=dev)
    dist._all_reduce(t)
    b = torch.full((4,), float(r), device=dev)
    dist._broadcast(b, 1)
    bits = torch.tensor([-0.0, float("nan"), 1e-40, r], device=dev)
    g = dist._all_gather(bits.view(1, 4))
    h = dist._all_gather(torch.arange(3, device=dev, dtype=torch.int64) + r)
    rs = dist._reduce_scatter(torch.arange(4.0, device=dev) * (r + 1))
    return {"backend": np.array([dist.backend_name()]),
            "device": np.array([str(dev)]),
            "sum": t.cpu().numpy(), "bcast": b.cpu().numpy(),
            "gather_bits": g.cpu().view(torch.int32).numpy(),
            "gather_int": h.cpu().numpy(), "rscatter": rs.cpu().numpy()}


def case_fail(ctx):
    if ctx.rank == 1:
        os._exit(3)
    import time

    time.sleep(60)
    return {}


CASES = {n[len("case_"):]: f for n, f in globals().items()
         if n.startswith("case_")}


def main():
    out, cases = sys.argv[1], sys.argv[2].split(",")
    ctx = Ctx(out)
    results = {}
    for c in cases:
        for k, v in CASES[c](ctx).items():
            results[f"{c}/{k}"] = np.asarray(v)
    np.savez(os.path.join(out, f"rank{ctx.rank}.npz"), **results)
    return 0


if __name__ == "__main__":
    sys.exit(main())
