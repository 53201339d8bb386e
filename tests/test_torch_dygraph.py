"""The port's dygraph mode (``paddle_tpu_torch.dygraph``: the eager tape,
``Layer``, the eager optimizer updates, ``save_dygraph``, single-process
``DataParallel``) against the JAX package's, on the CPU.

Every case of ``tests/test_dygraph.py`` runs in both packages on the same
numpy inputs; ``seed_parameters(s)`` draws the parameters from the same
numpy ``RandomState`` in both, so both start from bit-identical weights.
Tolerances: float32 with different summation orders (XLA's fused
reductions against PyTorch's kernels), so losses, gradients and
parameters agree within rtol 1e-5 / atol 1e-6 over the 6 SGD steps of the
MNIST MLP; over 3 Adam, 3 Lamb and 3 Momentum steps the losses and
gradients within rtol 1e-5 / atol 1e-6 and the parameters within rtol
1e-5 / atol 1e-5 (a step's m / sqrt(v) does not scale with the gradient,
so where a gradient is near zero its last bits move a weight by a part of
the 0.01 learning rate).
Then the port's own tape rules, the ``grad_lower`` routing (the lookup's
gradient through its own rule, not autograd's scatter), the refusals,
the checkpoint format both ways, and a BERT-tiny in dygraph mode
(``tools/torch_dygraph_bert.py``) against the port's static BERT.
"""
import types

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu import dygraph as jdy

import paddle_tpu_torch as tfluid
from paddle_tpu_torch import dygraph as tdy

J = types.SimpleNamespace(
    name="jax", fluid=jfluid, dy=jdy,
    guard=lambda seed=0: jdy.guard(seed=seed))
T = types.SimpleNamespace(
    name="port", fluid=tfluid, dy=tdy,
    guard=lambda seed=0: tdy.guard(tfluid.CPUPlace(), seed=seed))
RTOL, ATOL = 1e-5, 1e-6
# parameters after adaptive updates: a thousandth of the 0.01 learning rate
# (m / sqrt(v) of a near-zero gradient moves a weight by up to the rate
# whatever the gradient's size, so a 1e-6 gradient difference there shows)
PARAM_ATOL = 1e-5


@pytest.fixture(autouse=True)
def _no_port_clip_leak():
    """The port's clip is process-global: no case leaves one behind."""
    from paddle_tpu_torch import clip

    yield
    clip._clip_attr["__global__"] = None


def _mlp(P, hidden=32):
    class MLP(P.dy.Layer):
        def __init__(self):
            super().__init__("mlp")
            self.fc1 = P.dy.FC(784, hidden, act="relu")
            self.fc2 = P.dy.FC(hidden, 10)

        def forward(self, x):
            return self.fc2(self.fc1(x))

    return MLP()


def _close(a, b, what):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=RTOL,
                               atol=ATOL, err_msg=what)


def _mnist_run(P, make_opt, steps, xb, yb):
    """``steps`` eager steps of the MLP: each step's loss, the gradient of
    every parameter before the update, and the parameters after."""
    losses, grads = [], []
    with P.guard():
        P.dy.seed_parameters(7)
        model = _mlp(P)
        init = {n: p.numpy().copy() for n, p in model.named_parameters()}
        opt = make_opt(P)
        x, y = P.dy.to_variable(xb), P.dy.to_variable(yb)
        for _ in range(steps):
            _, ce = P.dy.ops.softmax_with_cross_entropy(model(x), y)
            loss = P.dy.ops.mean(ce)
            losses.append(float(loss.numpy()))
            loss.backward()
            grads.append({n: p.gradient() for n, p in
                          model.named_parameters()})
            opt.minimize(loss, parameter_list=model.parameters())
            model.clear_gradients()
        params = {n: p.numpy() for n, p in model.named_parameters()}
    return losses, grads, params, init


def _mnist_batch():
    rng = np.random.RandomState(0)
    return (rng.randn(32, 784).astype(np.float32),
            rng.randint(0, 10, (32, 1)).astype(np.int64))


def _port_static_reference(init, xb, yb, steps, lr):
    """The same model and updates on the port's static path, parameters
    set from the dygraph model's."""
    import paddle_tpu_torch.unique_name as un

    with un.guard():
        main, startup = tfluid.Program(), tfluid.Program()
        with tfluid.program_guard(main, startup):
            x = tfluid.layers.data("x", shape=[784], dtype="float32")
            y = tfluid.layers.data("y", shape=[1], dtype="int64")
            h = tfluid.layers.fc(x, 32, act="relu", name="s1")
            logits = tfluid.layers.fc(h, 10, name="s2")
            loss = tfluid.layers.mean(
                tfluid.layers.softmax_with_cross_entropy(logits, y))
            tfluid.optimizer.SGD(learning_rate=lr).minimize(loss)
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    exe.run(startup, scope=scope)
    for name, key in [("s1.w_0", "fc1.weight"), ("s1.b_0", "fc1.bias"),
                      ("s2.w_0", "fc2.weight"), ("s2.b_0", "fc2.bias")]:
        assert scope.find_var(name) is not None
        scope.set_var(name, torch.from_numpy(init[key]))
    return [float(np.ravel(exe.run(main, feed={"x": xb, "y": yb},
                                   fetch_list=[loss.name], scope=scope)[0])[0])
            for _ in range(steps)]


def test_dygraph_mnist_matches_jax_and_static():
    """6 SGD steps of the MLP: the port's losses and gradients against the
    JAX package's dygraph run, and the losses against the port's static
    path."""
    xb, yb = _mnist_batch()

    def sgd(P):
        return P.fluid.optimizer.SGD(learning_rate=0.5)

    tl, tg, tp, tinit = _mnist_run(T, sgd, 6, xb, yb)
    jl, jg, jp, jinit = _mnist_run(J, sgd, 6, xb, yb)
    for n in tinit:
        np.testing.assert_array_equal(tinit[n], jinit[n])
    _close(tl, jl, "losses")
    for step, (a, b) in enumerate(zip(tg, jg)):
        for n in a:
            _close(a[n], b[n], f"step {step} grad {n}")
    for n in tp:
        _close(tp[n], jp[n], f"param {n}")
    st = _port_static_reference(tinit, xb, yb, 6, 0.5)
    np.testing.assert_allclose(tl, st, rtol=1e-4, atol=1e-6)
    assert tl[-1] < tl[0]


@pytest.mark.parametrize("opt", ["adam", "lamb", "momentum"])
def test_dygraph_eager_updates_match_jax(opt):
    """3 steps of Adam, Lamb and Momentum: losses, gradients and
    parameters against the JAX package's eager updates."""
    xb, yb = _mnist_batch()

    def make(P):
        o = P.fluid.optimizer
        return {"adam": lambda: o.Adam(learning_rate=0.01),
                "lamb": lambda: o.Lamb(learning_rate=0.01,
                                       lamb_weight_decay=0.01),
                "momentum": lambda: o.Momentum(learning_rate=0.1,
                                               momentum=0.9,
                                               use_nesterov=True)}[opt]()

    tl, tg, tp, _ = _mnist_run(T, make, 3, xb, yb)
    jl, jg, jp, _ = _mnist_run(J, make, 3, xb, yb)
    _close(tl, jl, "losses")
    for step, (a, b) in enumerate(zip(tg, jg)):
        for n in a:
            _close(a[n], b[n], f"step {step} grad {n}")
    for n in tp:
        np.testing.assert_allclose(tp[n], jp[n], rtol=RTOL, atol=PARAM_ATOL,
                                   err_msg=f"param {n}")


def test_dygraph_adam_trains():
    rng = np.random.RandomState(1)
    xb = rng.randn(16, 8).astype(np.float32)
    w_true = rng.randn(8, 1).astype(np.float32)
    yb = xb @ w_true
    out = {}
    for P in (T, J):
        with P.guard():
            P.dy.seed_parameters(3)
            fc = P.dy.Linear(8, 1)
            opt = P.fluid.optimizer.Adam(learning_rate=0.05)
            losses = []
            for _ in range(40):
                pred = fc(P.dy.to_variable(xb))
                loss = P.dy.ops.mean(
                    P.dy.ops.square(pred - P.dy.to_variable(yb)))
                loss.backward()
                opt.minimize(loss, parameter_list=fc.parameters())
                fc.clear_gradients()
                losses.append(float(loss.numpy()))
        out[P.name] = losses
    assert out["port"][-1] < out["port"][0] * 0.05
    np.testing.assert_allclose(out["port"], out["jax"], rtol=1e-4, atol=1e-6)


def _layers_forward(P):
    rng = np.random.RandomState(2)
    res = {}
    with P.guard():
        P.dy.seed_parameters(11)
        img = P.dy.to_variable(rng.randn(2, 3, 8, 8).astype(np.float32))
        conv = P.dy.Conv2D(3, 6, 3, padding=1, act="relu")
        bn = P.dy.BatchNorm(6)
        pool = P.dy.Pool2D(2, "max", 2)
        res["conv_bn_pool"] = pool(bn(conv(img))).numpy()
        res["bn_mean"], res["bn_var"] = bn._mean.numpy(), bn._variance.numpy()
        ln = P.dy.LayerNorm(16)
        z = ln(P.dy.to_variable(rng.randn(4, 16).astype(np.float32)))
        res["ln"] = z.numpy()
        emb = P.dy.Embedding([50, 12])
        res["emb"] = emb(P.dy.to_variable(
            np.array([[1, 2], [3, 4]], np.int64))).numpy()
        drop = P.dy.Dropout(0.5)
        drop.eval()
        res["drop_eval"] = drop(z).numpy()
        bn.eval()
        res["bn_eval"] = bn(conv(img)).numpy()
    return res


def test_dygraph_layers_forward():
    """Conv2D/BatchNorm/Pool2D/LayerNorm/Embedding/Dropout eager outputs
    and BatchNorm's running statistics against the JAX package's."""
    t, j = _layers_forward(T), _layers_forward(J)
    assert t["conv_bn_pool"].shape == (2, 6, 4, 4)
    assert t["emb"].shape == (2, 2, 12)
    np.testing.assert_allclose(t["ln"].mean(axis=-1), 0, atol=1e-5)
    # reference downgrade_in_infer: inference output is x * (1 - p)
    np.testing.assert_allclose(t["drop_eval"], t["ln"] * 0.5, rtol=1e-6)
    assert not np.allclose(t["bn_mean"], 0)
    for k in t:
        _close(t[k], j[k], k)


def test_dygraph_python_control_flow():
    """Data-dependent Python control flow: the same trip count and the
    same gradient as the JAX package."""
    out = {}
    for P in (T, J):
        with P.guard():
            P.dy.seed_parameters(5)
            fc = P.dy.Linear(4, 4)
            x = P.dy.to_variable(np.ones((2, 4), np.float32))
            h, steps = x, 0
            while float(P.dy.ops.mean(h).numpy()) < 5 and steps < 50:
                h = P.dy.ops.relu(fc(h)) + 1.0
                steps += 1
            loss = P.dy.ops.mean(h)
            loss.backward()
            out[P.name] = (steps, fc.weight.gradient(), fc.bias.gradient())
    assert out["port"][0] == out["jax"][0] > 0
    _close(out["port"][1], out["jax"][1], "weight grad")
    _close(out["port"][2], out["jax"][2], "bias grad")


def test_dygraph_state_dict_roundtrip(tmp_path):
    with T.guard():
        model = _mlp(T, hidden=16)
        ref = model.fc1.weight.numpy().copy()
        tdy.save_dygraph(model.state_dict(), str(tmp_path / "mlp"))
        model2 = _mlp(T, hidden=16)
        assert not np.allclose(model2.fc1.weight.numpy(), ref)
        state, opt_state = tdy.load_dygraph(str(tmp_path / "mlp"))
        assert opt_state is None
        model2.set_dict(state)
        np.testing.assert_array_equal(model2.fc1.weight.numpy(), ref)
        with pytest.raises(ValueError, match="shape"):
            bad = dict(state)
            bad["fc1.weight"] = np.zeros((2, 2), np.float32)
            model2.set_dict(bad)
        with pytest.raises(KeyError, match="missing"):
            model2.set_dict({})


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_pdparams_written_by_either_package_loads_in_the_other(tmp_path,
                                                               writer):
    """``.pdparams.npz`` is one format: a file either package writes
    loads in the other and restores the same weights."""
    src, dst = (J, T) if writer == "jax" else (T, J)
    with src.guard():
        src.dy.seed_parameters(21)
        model = _mlp(src, hidden=16)
        want = model.state_dict()
        src.dy.save_dygraph(want, str(tmp_path / "m"))
    assert (tmp_path / "m.pdparams.npz").exists()
    with dst.guard():
        dst.dy.seed_parameters(22)
        model = _mlp(dst, hidden=16)
        state, _ = dst.dy.load_dygraph(str(tmp_path / "m"))
        model.set_dict(state)
        got = model.state_dict()
    assert set(got) == set(want)
    for n in want:
        np.testing.assert_array_equal(got[n], want[n])


def test_dygraph_grad_accumulation_and_clear():
    out = {}
    for P in (T, J):
        with P.guard():
            P.dy.seed_parameters(1)
            fc = P.dy.Linear(3, 1)
            x = P.dy.to_variable(np.ones((2, 3), np.float32))
            P.dy.ops.mean(fc(x)).backward()
            g1 = fc.weight.gradient().copy()
            P.dy.ops.mean(fc(x)).backward()
            np.testing.assert_allclose(fc.weight.gradient(), 2 * g1,
                                       rtol=1e-6)
            out[P.name] = fc.weight.gradient()
            fc.clear_gradients()
            assert fc.weight.gradient() is None
    _close(out["port"], out["jax"], "accumulated grad")


def test_dygraph_lamb_is_real_lamb():
    """Lamb's eager path applies the trust-ratio-scaled lamb rule (the
    'lamb' registry rule), not a plain Adam update."""
    with T.guard():
        fc = tdy.nn.FC(4, 4)
        x = tdy.to_variable(np.ones((2, 4), np.float32))
        opt = tfluid.optimizer.LambOptimizer(learning_rate=0.1,
                                             lamb_weight_decay=0.01)
        loss = tdy.ops.reduce_mean(fc(x))
        loss.backward()
        params = list(fc.parameters())
        before = {p.name: p.numpy().copy() for p in params}
        grads = {p.name: p.gradient() for p in params}
        opt.minimize(loss, parameter_list=params)
        for p in params:
            g, w = grads[p.name], before[p.name]
            b1, b2, eps, wd = 0.9, 0.999, 1e-6, 0.01
            m1h = ((1 - b1) * g) / (1 - b1)
            m2h = ((1 - b2) * g * g) / (1 - b2)
            r = m1h / (np.sqrt(m2h) + eps) + wd * w
            wn, rn = np.sqrt((w ** 2).sum()), np.sqrt((r ** 2).sum())
            ratio = wn / rn if (wn > 0 and rn > 0) else 1.0
            np.testing.assert_allclose(p.numpy(), w - 0.1 * ratio * r,
                                       atol=1e-5)


# ------------------------------------------------------------ tape rules
def test_tape_rules_match_the_jax_package():
    for P in (T, J):
        with P.guard():
            fc = P.dy.Linear(3, 2)
            other = P.dy.Linear(3, 2)
            x = P.dy.to_variable(np.ones((2, 3), np.float32))
            # a target not produced on the tape
            with pytest.raises(RuntimeError, match="not produced"):
                x.backward()
            # no differentiable leaf
            y = P.dy.ops.scale(x, scale=2.0)
            with pytest.raises(RuntimeError, match="no differentiable"):
                y.backward()
            # a parameter the loss does not reach keeps no gradient
            loss = P.dy.ops.mean(fc(x))
            loss.backward()
            assert fc.weight.gradient() is not None
            assert other.weight.gradient() is None
            # the tape reset: the loss is gone from it
            with pytest.raises(RuntimeError, match="not produced"):
                loss.backward()
            # retain_graph keeps it for a second backward
            fc.clear_gradients()
            loss = P.dy.ops.mean(fc(x))
            loss.backward(retain_graph=True)
            g = fc.weight.gradient().copy()
            loss.backward()
            np.testing.assert_allclose(fc.weight.gradient(), 2 * g,
                                       rtol=1e-6)
            # raw control-flow ops are refused
            with pytest.raises(RuntimeError, match="control-flow"):
                P.dy.ops.conditional_block(x)


def test_integer_leaves_take_no_gradient_and_detach_stops_it():
    with T.guard():
        w = tdy.to_variable(np.ones((4, 3), np.float32))
        w.stop_gradient = False
        ids = tdy.to_variable(np.array([[1], [3]], np.int64))
        ids.stop_gradient = False
        loss = tdy.ops.reduce_sum(tdy.ops.lookup_table(w, ids))
        loss.backward()
        assert ids.gradient() is None
        np.testing.assert_array_equal(w.gradient()[:, 0], [0, 1, 0, 1])
        d = w.detach()
        assert d.stop_gradient and d.gradient() is None


def test_in_dygraph_mode_follows_the_guard():
    assert not tfluid.in_dygraph_mode()
    assert not tfluid.framework.in_dygraph_mode()
    with T.guard():
        assert tfluid.in_dygraph_mode() and tdy.enabled()
        assert tdy.current_tape().device == torch.device("cpu")
    assert not tfluid.in_dygraph_mode()
    with pytest.raises(RuntimeError, match="not in dygraph mode"):
        tdy.current_tape()


def test_guard_without_a_place_means_the_card():
    if torch.cuda.is_available():
        pytest.skip("checks the refusal where CUDA is missing")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        with tdy.guard():
            pass


def test_set_value_rebinds_and_keeps_taking_gradients():
    with T.guard():
        fc = tdy.Linear(3, 2)
        x = tdy.to_variable(np.ones((2, 3), np.float32))
        loss = tdy.ops.mean(fc(x))
        old = fc.weight.value
        saved = old.detach().clone()
        fc.weight.set_value(np.full((3, 2), 2.0, np.float32))
        assert fc.weight.value is not old
        torch.testing.assert_close(old.detach(), saved)   # no write into it
        assert fc.weight.value.requires_grad
        loss.backward()           # the recorded graph is intact
        fc.clear_gradients()
        tdy.ops.mean(fc(x)).backward()
        assert fc.weight.gradient() is not None


def test_lookup_gradient_goes_through_its_own_rule(monkeypatch):
    """``lookup_table`` carries a ``grad_lower`` (a sum in a fixed
    order): the eager backward calls it, not autograd's scatter-add, and
    gives the JAX package's gradient."""
    from paddle_tpu_torch.core import registry

    opdef = registry.get_op_def("lookup_table")
    calls = []
    real = opdef.grad_lower

    def spy(ctx, ins, attrs):
        calls.append(sorted(ins))
        return real(ctx, ins, attrs)

    monkeypatch.setattr(opdef, "grad_lower", spy)
    rng = np.random.RandomState(4)
    ids = rng.randint(0, 10, (6, 5)).astype(np.int64)
    g = rng.randn(6, 5, 3).astype(np.float32)
    out = {}
    for P in (T, J):
        with P.guard():
            P.dy.seed_parameters(9)
            emb = P.dy.Embedding([10, 3])
            e = emb(P.dy.to_variable(ids))
            loss = P.dy.ops.reduce_sum(
                P.dy.ops.elementwise_mul(e, P.dy.to_variable(g)))
            loss.backward()
            out[P.name] = emb.weight.gradient()
    assert len(calls) == 1 and "Out@GRAD" in calls[0] \
        and "__out__Out" in calls[0]
    _close(out["port"], out["jax"], "embedding grad")


def test_refused_optimizers_and_missing_parameter_list():
    with T.guard():
        fc = tdy.Linear(3, 1)
        loss = tdy.ops.mean(fc(tdy.to_variable(np.ones((2, 3), np.float32))))
        loss.backward()
        with pytest.raises(ValueError, match="parameter_list"):
            tfluid.optimizer.SGD(0.1).minimize(loss)
        for opt in (tfluid.optimizer.Adagrad(0.1),
                    tfluid.optimizer.RMSProp(0.1)):
            with pytest.raises(NotImplementedError,
                               match="no eager \\(dygraph\\) update path"):
                opt.minimize(loss, parameter_list=fc.parameters())
        fc.clear_gradients()
        with pytest.raises(RuntimeError, match="no gradients found"):
            tfluid.optimizer.SGD(0.1).minimize(
                loss, parameter_list=fc.parameters())


def test_one_learning_rate_tensor_a_step(monkeypatch):
    """The eager update builds the learning-rate tensor once a step for
    each dtype, not once a parameter."""
    made = []
    real = torch.tensor

    def counting(*a, **k):
        made.append(a)
        return real(*a, **k)

    with T.guard():
        model = _mlp(T, hidden=8)
        x = tdy.to_variable(np.ones((2, 784), np.float32))
        opt = tfluid.optimizer.SGD(learning_rate=0.1)
        tdy.ops.mean(model(x)).backward()
        monkeypatch.setattr(torch, "tensor", counting)
        opt.minimize(None, parameter_list=model.parameters())
    assert len(made) == 1 and len(model.parameters()) == 4


def test_data_parallel_single_rank_and_multi_rank_refusal(monkeypatch):
    with T.guard():
        model = tdy.DataParallel(_mlp(T, hidden=8))
        assert tdy.prepare_context().nranks == 1
        x = tdy.to_variable(np.ones((2, 784), np.float32))
        loss = model.scale_loss(tdy.ops.mean(model(x)))
        loss.backward()
        model.apply_collective_grads()
        assert len(model.parameters()) == 4
        # two ranks named but no launcher's endpoints: the bootstrap
        # refuses, and the collective never silently runs on one rank
        # (two launched ranks: tests/test_torch_dist_launch.py)
        monkeypatch.setenv("PADDLE_TRAINERS_NUM", "2")
        monkeypatch.setenv("PADDLE_DIST_BACKEND", "cpu")
        with pytest.raises(RuntimeError, match="PADDLE_TRAINER_ENDPOINTS"):
            tdy.prepare_context()
        dp = tdy.DataParallel(_mlp(T, hidden=8))
        tdy.ops.mean(dp(x)).backward()
        with pytest.raises(RuntimeError, match="prepare_context"):
            dp.apply_collective_grads()
    env = tdy.ParallelEnv()
    assert env.world_size == 2 and env.rank == 0


# ------------------------------------------------------------ dygraph BERT
def _bert_feed(vocab, B, S, seed=0):
    """A pretraining batch: random tokens, two segments, padded lengths
    in [S/2, S], 15 % of the real tokens masked."""
    rng = np.random.RandomState(seed)
    lens = rng.randint(S // 2, S + 1, (B, 1))
    real = np.arange(S)[None] < lens
    masked = real & (rng.rand(B, S) < 0.15)
    return {"src_ids": rng.randint(0, vocab, (B, S)).astype(np.int64),
            "pos_ids": np.tile(np.arange(S, dtype=np.int64), (B, 1)),
            "sent_ids": (np.arange(S)[None] >= lens // 2).astype(np.int64),
            "input_mask": real.astype(np.float32),
            "mask_label": np.where(masked, rng.randint(0, vocab, (B, S)),
                                   -100).astype(np.int64),
            "next_sent_label": rng.randint(0, 2, (B, 1)).astype(np.int64)}


def test_dygraph_bert_tiny_matches_the_static_bert():
    """BERT-tiny in dygraph mode (``tools/torch_dygraph_bert.py``, the
    card's ``dygraph`` phase model) against the port's static BERT from
    the same weights, dropout 0: losses of 3 Adam steps and every
    parameter after them within rtol 1e-5 / atol 1e-6 (on the CPU the two
    sum the same way and agree bit for bit today)."""
    from paddle_tpu_torch.models.bert import BertConfig, build_bert_pretrain
    from tools.torch_dygraph_bert import DygraphBert, load_static, to_feed

    cfg = BertConfig.tiny()
    cfg.hidden_dropout = cfg.attention_dropout = 0.0
    with tfluid.unique_name.guard():
        net = build_bert_pretrain(cfg, seq_len=32, lr=1e-3)
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    exe.run(net["startup"], scope=scope)
    init = {n: v.clone() for n, v in scope.vars.items()}
    feed = _bert_feed(cfg.vocab_size, 4, 32)
    static = [exe.run(net["main"], feed=feed,
                      fetch_list=[net["loss"], net["mlm_loss"],
                                  net["nsp_loss"]], scope=scope)
              for _ in range(3)]
    with T.guard():
        model = DygraphBert(cfg)
        load_static(model, net["main"], init)
        opt = tfluid.optimizer.Adam(learning_rate=1e-3)
        f = to_feed(feed)
        dy = []
        for _ in range(3):
            outs = model(f)
            dy.append([float(np.ravel(o.numpy())[0]) for o in outs])
            outs[0].backward()
            opt.minimize(outs[0], parameter_list=model.parameters())
            model.clear_gradients()
        names = model.static_names(net["main"])
        for n, p in model.named_parameters():
            _close(p.numpy(), scope.numpy(names[n]), n)
    _close(dy, [[float(np.ravel(v)[0]) for v in step] for step in static],
           "losses")


def test_dropout_draws_new_masks_each_step_and_repeats_under_one_seed():
    """Each step (a ``backward()`` that resets the tape) draws new dropout
    masks, and two runs under one guard seed draw the same ones. The JAX
    package keys on the tape position alone, so its steps repeat one
    mask (ROADMAP Queue C); the port keys the step too."""
    def run(seed):
        masks = []
        with tdy.guard(tfluid.CPUPlace(), seed=seed):
            w = tdy.to_variable(np.ones((64, 64), np.float32))
            w.stop_gradient = False
            for _ in range(3):
                out, mask = tdy.ops.dropout(w, dropout_prob=0.5)
                masks.append(mask.numpy().copy())
                tdy.ops.reduce_sum(out).backward()
        return masks

    a, b = run(3), run(3)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    assert not np.array_equal(a[0], a[1]) and not np.array_equal(a[1], a[2])
    assert not np.array_equal(a[0], run(4)[0])
    with jdy.guard(seed=3):
        jm = []
        w = jdy.to_variable(np.ones((64, 64), np.float32))
        w.stop_gradient = False
        for _ in range(2):
            out, mask = jdy.ops.dropout(w, dropout_prob=0.5)
            jm.append(np.asarray(mask.value))
            jdy.ops.reduce_sum(out).backward()
    np.testing.assert_array_equal(jm[0], jm[1])
