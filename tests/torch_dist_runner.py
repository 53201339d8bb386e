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
TP_SEQ, TP_BATCH, TP_STEPS = 32, 4, 2
RING = dict(B=2, T=16, H=2, D=8)


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


def tp_feeds(seed=1):
    """BERT-tiny's feeds at seq 32, four rows."""
    return bert_feeds(seed, batch=TP_BATCH, seq=TP_SEQ)


def ring_inputs(seed=0):
    """q, k, v ``[B, T, H, D]`` and the weights of the loss sum(o * w)."""
    rng = np.random.RandomState(seed)
    shape = (RING["B"], RING["T"], RING["H"], RING["D"])
    return [(rng.randn(*shape) * 0.5).astype(np.float32) for _ in range(4)]


def build_ring_fluid(fluid, seq_par, B, H, S, D, bias=False, dropout=0.0):
    """``__graft_entry__._dryrun_ring_attention_fluid_api``'s program:
    fc -> fused_multihead_attention(causal) -> square error -> SGD."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        xv = fluid.layers.data("x", shape=[H, S, D], dtype="float32")
        yv = fluid.layers.data("y", shape=[H, S, D], dtype="float32")
        q = fluid.layers.fc(xv, D, num_flatten_dims=3,
                            param_attr=fluid.ParamAttr(name="wq"),
                            bias_attr=False)
        mask = None
        if bias:
            mask = fluid.layers.data("m", shape=[S], dtype="float32")
        o = fluid.layers.fused_multihead_attention(
            q, xv, xv, bias_qk=mask, causal=True, sequence_parallel=seq_par,
            attn_dropout=dropout)
        loss = fluid.layers.mean(fluid.layers.square_error_cost(o, yv))
        fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return main, startup, loss


def ring_fluid_feeds(B, H, S, D):
    rng = np.random.RandomState(1)
    return {"x": rng.randn(B, H, S, D).astype(np.float32) * 0.3,
            "y": rng.randn(B, H, S, D).astype(np.float32) * 0.3}


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


# -- model parallelism: tensor parallel and ring attention -----------------

def _tp_run(ctx, mesh_shape, zero=False, dropout=0.0, steps=TP_STEPS,
            replica_check=False):
    """BERT-tiny over ``mesh_shape`` with the transformer tp rules, from
    the JAX package's initial scope (``init_tp.npz``) planted sharded:
    step 1's loss and gathered gradients, every step's loss, the
    gathered parameters after the last step, this rank's state bytes and
    the collective bytes of step 1 by kind."""
    import paddle_tpu_torch as fluid
    import paddle_tpu_torch.unique_name as un
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.interop import scope_from_numpy
    from paddle_tpu_torch.models.bert import BertConfig, build_bert_pretrain
    from paddle_tpu_torch.parallel.sharding import (Mesh,
                                                    compile_sharded_step,
                                                    transformer_tp_rules)

    mesh, rules = Mesh(mesh_shape), transformer_tp_rules()
    with un.guard():
        m = build_bert_pretrain(bert_cfg(BertConfig, dropout), seq_len=TP_SEQ)
    main, loss = m["main"], m["loss"]
    exe = fluid.Executor(ctx.place)
    scope = fluid.Scope()
    scope_from_numpy(ctx.load("init_tp.npz"), scope, ctx.place,
                     programs=[main], mesh=mesh, rules=rules)
    names = param_grads(main)
    run, io = compile_sharded_step(main, mesh, m["feeds"],
                                   [loss.name] + names, rules)
    if zero:
        io["compiled"]._build_strategy.reduce_strategy = \
            fluid.BuildStrategy.ReduceStrategy.Reduce
    if replica_check:
        fluid.set_flags({"FLAGS_replica_check_interval": 1})
    dp, c = mesh.shape.get("dp", 1), mesh.coord("dp")
    k = TP_BATCH // dp
    shard = {n: v[c * k:(c + 1) * k] for n, v in tp_feeds().items()}
    res, losses, diverged = {}, [], []
    params = [p.name for p in main.all_parameters()]
    try:
        dist.reset_collective_stats()
        out = run(exe, shard, scope)
        stats = dist.collective_stats()["by_kind"]
        res.update({"grad/" + n: v for n, v in zip(names, out[1:])})
        losses.append(float(out[0].reshape(-1)[0]))
        for _ in range(steps - 1):
            got = exe.run(io["compiled"], feed=shard,
                          fetch_list=[loss.name] + params, scope=scope)
            losses.append(float(got[0].reshape(-1)[0]))
    except RuntimeError as e:       # ReplicaDivergenceError
        diverged.append(str(e))
        stats = {}
    finally:
        fluid.set_flags({"FLAGS_replica_check_interval": 0})
    if not diverged and steps > 1:
        res.update({"param/" + p: v for p, v in zip(params, got[1:])})
    res["losses"] = np.array(losses)
    res["diverged"] = np.array(diverged or [""])
    state = [v for n, v in scope.vars.items() if hasattr(v, "numel")
             and (n in params or n.startswith(("moment1_", "moment2_")))]
    res["state_bytes"] = np.array([sum(v.numel() * v.element_size()
                                       for v in state)])
    for kind, v in stats.items():
        res[f"coll/{kind}"] = np.array([v["calls"], v["bytes"]])
    return res


def case_tp_bert(ctx):
    return _tp_run(ctx, {"tp": 2})


def case_dptp_bert(ctx):
    return _tp_run(ctx, {"dp": 2, "tp": 2})


def case_dptp_dropout(ctx):
    """dp2 x tp2 at dropout 0.1 under ZeRO-1, the replica check every
    step: the tp ranks hold replicated state that must stay identical."""
    return _tp_run(ctx, {"dp": 2, "tp": 2}, zero=True, dropout=0.1,
                   steps=3, replica_check=True)


def case_dptp_badseed(ctx):
    """Negative control: the whole rank folded into the step seed, so the
    two ranks of a tp group draw different dropout masks."""
    from paddle_tpu_torch.parallel import compiled_program as cp

    cp._DPPlan.fold_seed = \
        lambda self, seed: (seed + self.rank * 0x9E3779B1) & 0x7FFFFFFF
    return _tp_run(ctx, {"dp": 2, "tp": 2}, zero=True, dropout=0.1,
                   steps=3, replica_check=True)


def case_tp_drop_allreduce(ctx):
    """Negative control: the plan leaves the first row-parallel
    product's partial sum unsummed."""
    from paddle_tpu_torch.parallel import compiled_program as cp

    init = cp._DPPlan.__init__

    def patched(self, program, *a, **kw):
        init(self, program, *a, **kw)
        ops = program.global_block.ops
        first = min(i for i, evs in self.partial.items()
                    if ops[i].type == "mul")
        del self.partial[first]
    cp._DPPlan.__init__ = patched
    return _tp_run(ctx, {"tp": 2}, steps=1)


def case_ring_fn(ctx):
    """``ring_attention`` at sp = 2, causal and not: the output and the
    gradients of sum(o * w) on this rank."""
    import torch

    from paddle_tpu_torch.parallel.ring_attention import ring_attention
    from paddle_tpu_torch.parallel.sharding import Mesh

    mesh = Mesh({"sp": ctx.world})
    res = {}
    for causal in (False, True):
        q, k, v, w = (torch.from_numpy(a) for a in ring_inputs())
        for t in (q, k, v):
            t.requires_grad_()
        o = ring_attention(q, k, v, mesh, causal=causal)
        (o * w).sum().backward()
        tag = "causal" if causal else "full"
        res[f"{tag}/o"] = o.detach().numpy()
        for n, t in zip("qkv", (q, k, v)):
            res[f"{tag}/d{n}"] = t.grad.numpy()
    return res


def _ring_fluid_run(ctx, mesh_shape, steps=3):
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.parallel.sharding import Mesh

    mesh = Mesh(mesh_shape)
    dp, sp = mesh.shape.get("dp", 1), mesh.shape.get("sp", 1)
    B, H, S, D = 2 * dp, 2, 4 * sp, 8
    main, startup, loss = build_ring_fluid(fluid, True, B, H, S, D)
    exe = fluid.Executor(ctx.place)
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    scope.set_var("wq", np.eye(D, dtype=np.float32))
    prog = fluid.CompiledProgram(main).with_data_parallel(
        loss_name=loss.name, places=mesh)
    c = mesh.coord("dp")
    feed = {n: v[c * 2:(c + 1) * 2]
            for n, v in ring_fluid_feeds(B, H, S, D).items()}
    losses = [float(exe.run(prog, feed=feed, fetch_list=[loss.name],
                            scope=scope)[0].reshape(-1)[0])
              for _ in range(steps)]
    return {"losses": np.array(losses), "wq": scope.numpy("wq")}


def case_ring_fluid(ctx):
    return _ring_fluid_run(ctx, {"sp": ctx.world})


def case_ring_fluid_dpsp(ctx):
    return _ring_fluid_run(ctx, {"dp": 2, "sp": 2})


def case_ring_refusals(ctx):
    """The ring path's refusals inside a parallel step over sp."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.parallel.sharding import Mesh

    mesh = Mesh({"sp": ctx.world})
    B, H, S, D = 2, 2, 8, 8
    res = {}
    for what, kw in (("bias", dict(bias=True)),
                     ("dropout", dict(dropout=0.1))):
        main, startup, loss = build_ring_fluid(fluid, True, B, H, S, D, **kw)
        exe, scope = fluid.Executor(ctx.place), fluid.Scope()
        exe.run(startup, scope=scope)
        feed = ring_fluid_feeds(B, H, S, D)
        if kw.get("bias"):
            feed["m"] = np.zeros((B, S), np.float32)
        prog = fluid.CompiledProgram(main).with_data_parallel(
            loss_name=loss.name, places=mesh)
        try:
            exe.run(prog, feed=feed, fetch_list=[loss.name], scope=scope)
            res[what] = np.array(["no refusal"])
        except Exception as e:      # OpLoweringError naming the op's own
            res[what] = np.array([str(e)])
    return res


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


# -- pipeline parallelism: the region model of tests/test_pipeline.py -----

PP_D, PP_M, PP_ROWS, PP_STEPS = 16, 4, 8, 4
# the attention stage: BERT's block at hidden 64, 2 heads, seq 16
PP_ATTN = dict(hidden=64, heads=2, ffn=128, layers=2, stages=2,
               microbatches=2, seq=16, vocab=50)
PP_ATTN_BATCH, PP_ATTN_STEPS = 4, 3


def build_region(fluid, P, M=PP_M, D=PP_D, pre_fc=False):
    """``tests/test_pipeline.py``'s ``_build_region_model`` (tanh(x w + b)
    stages, square error, SGD 0.1); ``pre_fc`` puts an fc before the
    region, whose replicas every ``pp`` rank updates."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data("x", shape=[D], dtype="float32")
        y = fluid.layers.data("y", shape=[D], dtype="float32")
        if pre_fc:
            x = fluid.layers.fc(x, D, name="pre_fc")
        pipe = fluid.layers.PipelineRegion(num_stages=P, num_microbatches=M)
        with pipe.stage(x) as s:
            w = s.param("w", [D, D])
            b = s.param("b", [D], is_bias=True)
            h = fluid.layers.tanh(fluid.layers.elementwise_add(
                fluid.layers.matmul(s.input, w), b))
            s.set_output(h)
        loss = fluid.layers.mean(
            fluid.layers.square_error_cost(pipe.output, y))
        fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
    main.random_seed = 11
    startup.random_seed = 11
    return main, startup, loss


def region_init(P, D=PP_D):
    """``tests/test_pipeline.py``'s stacked weights and feeds."""
    rng = np.random.RandomState(3)
    return {"w": (rng.randn(P, D, D) / np.sqrt(D)).astype(np.float32),
            "b": (rng.randn(P, D) * 0.1).astype(np.float32),
            "x": rng.randn(PP_ROWS, D).astype(np.float32),
            "y": rng.randn(PP_ROWS, D).astype(np.float32)}


def plant_region(scope, init, place):
    import torch

    for n in list(scope.vars):
        for k in ("w", "b"):
            if n.endswith(f".{k}.pp_stacked") and not n.startswith(
                    ("velocity", "moment")):
                scope.set_var(n, torch.from_numpy(init[k].copy()).to(
                    place.torch_device()))


def _replica_steps(run, steps):
    """``steps`` calls of ``run`` under the replica check every step
    (policy raise): the losses and the diverged names (or none)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.resilience import ReplicaDivergenceError

    fluid.set_flags({"FLAGS_replica_check_interval": 1,
                     "FLAGS_replica_divergence_policy": "raise"})
    losses, named = [], ""
    try:
        for _ in range(steps):
            losses.append(run())
    except ReplicaDivergenceError as e:
        named = e.param
    finally:
        fluid.set_flags({"FLAGS_replica_check_interval": 0})
    return losses, named


def _pp_run(ctx, mesh_shape, P, pre_fc=False, replica=False,
            steps=PP_STEPS):
    """The region model over ``mesh_shape`` from ``region_init``: every
    step's loss, the stacked parameters gathered after the last step,
    this rank's stacked bytes, the names a replica check raised on."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.parallel.sharding import Mesh

    main, startup, loss = build_region(fluid, P, pre_fc=pre_fc)
    exe, scope = fluid.Executor(ctx.place), fluid.Scope()
    exe.run(startup, scope=scope)
    init = region_init(P)
    plant_region(scope, init, ctx.place)
    mesh = Mesh(mesh_shape)
    prog = fluid.CompiledProgram(main).with_data_parallel(
        loss_name=loss.name, places=mesh)
    dp, c = mesh.shape.get("dp", 1), mesh.coord("dp")
    k = PP_ROWS // dp
    feed = {n: init[n][c * k:(c + 1) * k] for n in ("x", "y")}
    stacked = sorted(p.name for p in main.all_parameters()
                     if p.name.endswith(".pp_stacked"))

    got = []

    def one():
        # the last step also fetches the stacked parameters it updates
        fetch = [loss.name] + (stacked if len(got) == steps - 1 else [])
        out = exe.run(prog, feed=feed, fetch_list=fetch, scope=scope)
        got.append(out)
        return float(out[0].reshape(-1)[0])
    if replica:
        losses, named = _replica_steps(one, steps)
    else:
        losses, named = [one() for _ in range(steps)], ""
    res = {"losses": np.array(losses), "named": np.array([named]),
           "stacked_bytes": np.array([sum(
               scope.find_var(n).numel() * 4 for n in stacked)])}
    if not named:
        res.update({"param/" + n.split(".")[1]: v
                    for n, v in zip(stacked, got[-1][1:])})
    return res


def case_pp2(ctx):
    return _pp_run(ctx, {"pp": 2}, 2)


def case_pp4(ctx):
    return _pp_run(ctx, {"pp": 4}, 4)


def case_dppp(ctx):
    return _pp_run(ctx, {"dp": 2, "pp": 2}, 2)


def case_dppp_fc(ctx):
    """An fc before the region under dp x pp, the replica check every
    step: its replicas across pp stay bit-identical."""
    return _pp_run(ctx, {"dp": 2, "pp": 2}, 2, pre_fc=True, replica=True)


def case_pp_attn(ctx):
    """The attention stage over {"pp": 2}, planted with this rank's
    slices (``interop.scope_from_numpy(mesh=)``): every step's loss and
    the gathered stacked parameters after the last step."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.interop import scope_from_numpy
    from paddle_tpu_torch.parallel.sharding import Mesh
    sys.path.insert(0, os.path.join(REPO, "tools"))
    import torch_mp_worker as W

    main, startup, loss = W.build_pipeline_encoder(fluid, **PP_ATTN)
    exe, scope = fluid.Executor(ctx.place), fluid.Scope()
    mesh = Mesh({"pp": 2})
    # planted cut: this rank's stage slice of every stacked var
    scope_from_numpy(ctx.load("init_pp_attn.npz"), scope, ctx.place,
                     programs=[main], mesh=mesh)
    stacked = main.global_block.var(
        next(p.name for p in main.all_parameters()
             if p.name.endswith(".pp_stacked")))
    assert scope.find_var(stacked.name).shape[0] == 1
    prog = fluid.CompiledProgram(main).with_data_parallel(
        loss_name=loss.name, places=mesh)
    feed = W.pipeline_feed(0, PP_ATTN_BATCH, PP_ATTN["seq"],
                           PP_ATTN["vocab"])
    names = sorted(p.name for p in main.all_parameters())
    losses = []
    for i in range(PP_ATTN_STEPS):
        got = exe.run(prog, feed=feed, fetch_list=[loss.name] + (
            names if i == PP_ATTN_STEPS - 1 else []), scope=scope)
        losses.append(float(got[0].reshape(-1)[0]))
    return {"losses": np.array(losses),
            **{"param/" + n: v for n, v in zip(names, got[1:])}}


def case_pp_fn(ctx):
    """``parallel.pipeline.pipeline`` called directly over {"pp": 2} on
    the region's weights and rows: the replicated outputs."""
    import torch

    from paddle_tpu_torch.parallel.pipeline import pipeline
    from paddle_tpu_torch.parallel.sharding import Mesh

    init = region_init(2)
    w, b, x = (torch.from_numpy(init[k]) for k in ("w", "b", "x"))

    def stage(params, h):
        return torch.tanh(h @ params[0] + params[1])
    out = pipeline(stage, [w, b], x, Mesh({"pp": 2}), PP_M)
    return {"out": out.numpy()}


def case_pp_dout_everywhere(ctx):
    """Negative control: every stage also pulls the output's cotangent
    back, not the last one alone."""
    from paddle_tpu_torch.parallel import pipeline as pl

    pl._cotangent = lambda s, P, g, recv: g if s == P - 1 else g + recv
    return _pp_run(ctx, {"pp": 2}, 2)


def case_dppp_no_broadcast(ctx):
    """Negative control: the input's cotangent stays on stage 0, so the
    fc before the region updates differently on the pp ranks."""
    import torch

    from paddle_tpu_torch.parallel import pipeline as pl

    pl._replicate_input_grad = \
        lambda buf, mine, group: buf if mine else torch.zeros_like(buf)
    return _pp_run(ctx, {"dp": 2, "pp": 2}, 2, pre_fc=True, replica=True)


# -- row-sharded tables: tests/dist_runner.py's DeepFM --------------------

FM = dict(num_fields=4, emb_dim=4, lr=0.05, sharded=True)
FM_STEPS, FM_SAVE_AFTER = 10, 2


def fm_feeds(vocab=64):
    """``tests/dist_runner.py``'s DeepFM batch (ids below 64 at any
    vocab)."""
    rng = np.random.RandomState(42)
    ids = rng.randint(0, 64, (GLOBAL_BATCH, 4)).astype(np.int64)
    return {"feat_ids": ids,
            "label": (ids.sum(1) % 2).astype(np.float32).reshape(-1, 1)}


def _fm_prog(ctx, vocab):
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.interop import scope_from_numpy
    from paddle_tpu_torch.models.deepfm import build_deepfm
    from paddle_tpu_torch.parallel.sharding import Mesh

    with fluid.unique_name.guard():
        m = build_deepfm(vocab=vocab, **FM)
    exe, scope = fluid.Executor(ctx.place), fluid.Scope()
    scope_from_numpy(ctx.load(f"init_fm_{vocab}.npz"), scope, ctx.place,
                     programs=[m["main"]], mesh=Mesh({"dp": ctx.world}))
    prog = _compiled(fluid, m["main"], m["loss"])
    return m, exe, scope, prog, ctx.shard(fm_feeds(vocab))


def _fm_run(ctx, vocab, steps=FM_STEPS):
    """DeepFM over dp from the JAX package's initial scope: the losses,
    the tables gathered after the last step, this rank's table + moment
    bytes and the collective bytes of a step by kind."""
    from paddle_tpu_torch import distributed as dist

    m, exe, scope, prog, feed = _fm_prog(ctx, vocab)
    losses = []
    for i in range(steps):
        dist.reset_collective_stats()
        # the last step also fetches the tables it updates
        got = exe.run(prog, feed=feed, fetch_list=[m["loss"].name] + (
            ["fm_v", "fm_w"] if i == steps - 1 else []), scope=scope)
        losses.append(float(got[0].reshape(-1)[0]))
        if i == 1:
            stats = dist.collective_stats()["by_kind"]
    tables = got[1:]
    held = sum(v.numel() * v.element_size() for n, v in scope.vars.items()
               if hasattr(v, "numel") and ("fm_v" in n or "fm_w" in n)
               and "@" not in n)
    res = {"losses": np.array(losses), "fm_v": tables[0],
           "fm_w": tables[1], "table_bytes": np.array([held]),
           "dp_shards": np.array(sorted(getattr(scope, "_dp_shards", {}))
                                 or [""])}
    for kind, v in stats.items():
        res[f"coll/{kind}"] = np.array([v["calls"], v["bytes"]])
    return res


def case_fm_rows(ctx):
    return _fm_run(ctx, 64)


def case_fm_replicated(ctx):
    return _fm_run(ctx, 65)


def case_fm_ckpt(ctx):
    """The row-sharded DeepFM: a sharded checkpoint after step 2, then
    steps 3-4; a fresh scope restores it and runs steps 3-4 again."""
    import paddle_tpu_torch as fluid

    m, exe, scope, prog, feed = _fm_prog(ctx, 64)

    def steps(exe, prog, scope, n):
        return [float(exe.run(prog, feed=feed, fetch_list=[m["loss"]],
                              scope=scope)[0].reshape(-1)[0])
                for _ in range(n)]
    first = steps(exe, prog, scope, FM_SAVE_AFTER)
    path = os.path.join(ctx.out, "ckpt_fm")
    fluid.io.save_checkpoint(exe, path, m["main"], scope=scope,
                             meta={"step": FM_SAVE_AFTER},
                             mesh={"dp": ctx.world})
    rest = steps(exe, prog, scope, 2)
    straight = exe.run(prog, feed=feed, fetch_list=["fm_v"], scope=scope)[0]
    exe2, scope2 = fluid.Executor(ctx.place), fluid.Scope()
    exe2.run(m["startup"], scope=scope2)
    meta = fluid.io.load_checkpoint(exe2, path, m["main"], scope=scope2)
    prog2 = _compiled(fluid, m["main"], m["loss"])
    resumed = steps(exe2, prog2, scope2, 2)
    again = exe2.run(prog2, feed=feed, fetch_list=["fm_v"],
                     scope=scope2)[0]
    return {"losses": np.array(first + rest), "resumed": np.array(resumed),
            "meta_step": np.array([meta["step"]]), "fm_v": straight,
            "fm_v_resumed": again}


def case_fm_rows_own_grad(ctx):
    """Negative control: each rank's table gradient from its own batch
    rows only (no gathered output gradient)."""
    from paddle_tpu_torch.parallel import compiled_program as cp

    orig = cp._DPPlan._row_lookup

    def own(self, i, op, run, env, lctx):
        if op.type != "lookup_table_grad":
            return orig(self, i, op, run, env, lctx)
        ids_name, off, rows = self.row_lookups[i]
        env[op.output("W@GRAD")[0]] = cp._sharded_rows_grad(
            env[ids_name], env[op.input("Out@GRAD")[0]], rows, off,
            op.attrs.get("padding_idx", -1))
    cp._DPPlan._row_lookup = own
    return _fm_run(ctx, 64)


SPARSE_TP = dict(vocab=64, dim=8, fields=4, steps=4)


def build_sparse_tp(fluid):
    """ids -> a sparse lookup into ``word_embedding`` (vocab-sharded by
    ``transformer_tp_rules``) -> fc -> square error, Adam."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        ids = fluid.layers.data("ids", shape=[SPARSE_TP["fields"]],
                                dtype="int64")
        y = fluid.layers.data("y", shape=[1], dtype="float32")
        emb = fluid.layers.embedding(
            ids, size=[SPARSE_TP["vocab"], SPARSE_TP["dim"]],
            is_sparse=True, padding_idx=5,
            param_attr=fluid.ParamAttr(name="word_embedding"))
        h = fluid.layers.reshape(
            emb, [-1, SPARSE_TP["fields"] * SPARSE_TP["dim"]])
        pred = fluid.layers.fc(h, 1, name="sp_fc")
        loss = fluid.layers.mean(fluid.layers.square_error_cost(pred, y))
        fluid.optimizer.Adam(learning_rate=0.05).minimize(loss)
    main.random_seed = 17
    startup.random_seed = 17
    return main, startup, loss


def sparse_tp_feeds():
    rng = np.random.RandomState(9)
    ids = rng.randint(0, SPARSE_TP["vocab"],
                      (GLOBAL_BATCH, SPARSE_TP["fields"])).astype(np.int64)
    ids[0, 1] = ids[3, 2] = 5            # the padding id, twice
    return {"ids": ids, "y": rng.randn(GLOBAL_BATCH, 1).astype(np.float32)}


def case_tp_sparse(ctx):
    """The sparse lookup over {"tp": 2}: the losses and the gathered table
    after the last step."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.parallel.sharding import (Mesh,
                                                    compile_sharded_step,
                                                    transformer_tp_rules)

    main, startup, loss = build_sparse_tp(fluid)
    exe, scope = fluid.Executor(ctx.place), fluid.Scope()
    exe.run(startup, scope=scope)
    run, io = compile_sharded_step(main, Mesh({"tp": ctx.world}),
                                   ["ids", "y"], [loss.name],
                                   transformer_tp_rules())
    feed = sparse_tp_feeds()
    losses = [float(run(exe, feed, scope)[0].reshape(-1)[0])
              for _ in range(SPARSE_TP["steps"] - 1)]
    # the last step also fetches the table it updates (gathered)
    got = exe.run(io["compiled"], feed=feed,
                  fetch_list=[loss.name, "word_embedding"], scope=scope)
    losses.append(float(got[0].reshape(-1)[0]))
    return {"losses": np.array(losses), "table": got[1]}


def build_merge_mlp(fluid, microbatches=2):
    """``build_mlp`` (Adam) under ``PipelineOptimizer``."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data("x", shape=[DIM], dtype="float32")
        y = fluid.layers.data("y", shape=[1], dtype="float32")
        h = fluid.layers.fc(x, 32, act="relu", name="d_fc1")
        pred = fluid.layers.fc(h, 1, name="d_fc2")
        loss = fluid.layers.mean(fluid.layers.square_error_cost(pred, y))
        fluid.optimizer.PipelineOptimizer(
            fluid.optimizer.Adam(learning_rate=0.02),
            num_microbatches=microbatches).minimize(loss)
    main.random_seed = 31
    startup.random_seed = 31
    return main, startup, loss


MERGE_STEPS = 4


def case_merge_dp(ctx):
    """Gradient merge (2 microbatches) under dp from the JAX package's
    initial scope: the parameters after ``MERGE_STEPS`` steps."""
    import paddle_tpu_torch as fluid

    main, startup, loss = build_merge_mlp(fluid)
    exe, scope = fluid.Executor(ctx.place), fluid.Scope()
    _plant(fluid, scope, ctx.load("init_merge.npz"), ctx.place, [main])
    prog = _compiled(fluid, main, loss)
    feed = ctx.shard(mlp_feeds())
    for _ in range(MERGE_STEPS):
        exe.run(prog, feed=feed, fetch_list=[loss], scope=scope)
    names = [p.name for p in main.all_parameters()]
    return {"param/" + n: scope.numpy(n) for n in names}


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
