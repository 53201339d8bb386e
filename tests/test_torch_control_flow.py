"""The port's control flow against the JAX package's, on the CPU: While,
cond, Switch, IfElse-style conditionals, StaticRNN, the tensor arrays and
beam search (the cases of tests/test_control_flow.py), and the While
gradient (the cases of tests/test_while_grad.py).

Each program is built by the same function in both packages; programs
with parameters run from the JAX package's initial scope, carried with
``interop.scope_from_numpy``. Float32 results agree within rtol 1e-5
(atol 1e-6), ids and counts exactly. Where the two differ by design (a
tensor-array write past its capacity: the reference clamps it into the
last row, the port raises), both behaviours are pinned."""
import numpy as np
import pytest

import paddle_tpu as fluid
import paddle_tpu.unique_name as jun

import paddle_tpu_torch as tfluid
import paddle_tpu_torch.unique_name as tun
from paddle_tpu_torch.interop import scope_from_numpy
from paddle_tpu_torch.ops import control_flow as tcf

PKGS = {"jax": (fluid, jun), "torch": (tfluid, tun)}
RTOL, ATOL = 1e-5, 1e-6


def _build(pkg, fn):
    fl, un = PKGS[pkg]
    with un.guard():
        main, startup = fl.Program(), fl.Program()
        with fl.program_guard(main, startup):
            res = fn(fl, fl.layers)
    return main, startup, res


class _Both:
    """One program built in both packages, the port's scope planted from
    the JAX package's initial state."""

    def __init__(self, fn, seed=0):
        self.progs = {p: _build(p, fn) for p in PKGS}
        self.exe = {p: PKGS[p][0].Executor(PKGS[p][0].CPUPlace())
                    for p in PKGS}
        self.scope = {p: PKGS[p][0].Scope() for p in PKGS}
        jmain, jstartup, _ = self.progs["jax"]
        jmain.random_seed = seed
        self.exe["jax"].run(jstartup, scope=self.scope["jax"])
        state = {n: self.scope["jax"].numpy(n)
                 for n in jstartup.global_block.vars}
        scope_from_numpy(state, self.scope["torch"], tfluid.CPUPlace(),
                         programs=[self.progs["torch"][0]])

    def res(self, pkg):
        return self.progs[pkg][2]

    def run(self, feed, fetch):
        """fetch(res) -> names; the two packages' results."""
        out = {}
        for p in PKGS:
            names = [v if isinstance(v, str) else v.name
                     for v in fetch(self.res(p))]
            out[p] = [np.asarray(a) for a in self.exe[p].run(
                self.progs[p][0], feed=feed, fetch_list=names,
                scope=self.scope[p])]
        return out["torch"], out["jax"]


def _close(got, want):
    for a, b in zip(got, want):
        assert a.shape == b.shape
        if a.dtype.kind in "iub":
            np.testing.assert_array_equal(a, b.astype(a.dtype))
        else:
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)


def _while_sum(fl, L):
    i = L.fill_constant([1], "int64", 0)
    n = L.fill_constant([1], "int64", 10)
    acc = L.fill_constant([1], "float32", 0.0)
    cond = L.less_than(i, n)
    w = L.While(cond)
    with w.block():
        fi = L.cast(i, "float32")
        L.assign(L.elementwise_add(acc, fi), acc)
        L.increment(i, value=1)
        L.assign(L.less_than(i, n), cond)
    return L.elementwise_add(acc, L.fill_constant([1], "float32", 0.0))


def test_while_sum_and_host_reads():
    """sum(0..9) by a While: 10 trips, 11 host reads of the condition."""
    both = _Both(_while_sum)
    tcf.reset_cond_reads()
    got, want = both.run({}, lambda out: [out])
    assert float(got[0][0]) == 45.0
    assert tcf.cond_reads() == 11
    _close(got, want)


def _while_array(fl, L):
    i = L.fill_constant([1], "int64", 0)
    n = L.fill_constant([1], "int64", 5)
    arr = L.create_array("float32")
    L.array_write(L.fill_constant([1], "float32", 0.0), i, arr)
    cond = L.less_than(i, n)
    w = L.While(cond, max_len=8)
    with w.block():
        fi = L.cast(i, "float32")
        L.array_write(L.elementwise_mul(fi, fi), i, arr)
        L.increment(i, value=1)
        L.assign(L.less_than(i, n), cond)
    return (L.tensor_array_to_tensor(arr), L.array_length(arr),
            L.array_read(arr, L.fill_constant([1], "int64", 3)))


def test_while_tensor_array_stacks_its_capacity():
    """i^2 collected in an array carried through a While of max_len 8:
    the stacked array has the capacity's 8 rows (the JAX package's
    shape), 5 written, and reads back by index."""
    both = _Both(_while_array)
    got, want = both.run({}, lambda out: list(out))
    assert got[0].shape == (8, 1)
    np.testing.assert_allclose(got[0][:5, 0], [0.0, 1.0, 4.0, 9.0, 16.0])
    assert int(got[1][0]) == 5 and float(got[2][0]) == 9.0
    _close(got, want)


def _cond_program(fl, L):
    x = L.data("x", shape=[1], dtype="float32")
    thr = L.fill_constant([1], "float32", 0.0)
    pred = L.greater_than(L.reduce_sum(x), L.reduce_sum(thr))
    return L.cond(pred, lambda: L.scale(x, scale=2.0),
                  lambda: L.scale(x, scale=-1.0))


@pytest.mark.parametrize("xv,want", [(3.0, 6.0), (-3.0, 3.0)])
def test_cond_branches(xv, want):
    both = _Both(_cond_program)
    got, ref = both.run({"x": np.array([[xv]], np.float32)},
                        lambda out: [out])
    assert float(got[0][0][0]) == want
    _close(got, ref)


def _switch_program(fl, L):
    step = L.data("step", shape=[1], dtype="float32")
    lr = L.fill_constant([1], "float32", 0.0)
    b1 = L.fill_constant([1], "float32", 10.0)
    b2 = L.fill_constant([1], "float32", 20.0)
    s = L.reduce_sum(step)
    with L.Switch() as sw:
        with sw.case(L.less_than(s, L.reduce_sum(b1))):
            L.assign(L.fill_constant([1], "float32", 0.1), lr)
        with sw.case(L.less_than(s, L.reduce_sum(b2))):
            L.assign(L.fill_constant([1], "float32", 0.01), lr)
        with sw.default():
            L.assign(L.fill_constant([1], "float32", 0.001), lr)
    return lr


@pytest.mark.parametrize("step,want", [(5.0, 0.1), (15.0, 0.01),
                                       (25.0, 0.001)])
def test_switch_piecewise(step, want):
    both = _Both(_switch_program)
    got, ref = both.run({"step": np.array([step], np.float32)},
                        lambda out: [out])
    assert abs(float(got[0][0]) - want) < 1e-7
    _close(got, ref)


SEQ, BATCH, DIN, DH = 4, 2, 3, 5


def _static_rnn(fl, L):
    x = L.data("x", shape=[SEQ, BATCH, DIN], dtype="float32",
               append_batch_size=False)
    rnn = L.StaticRNN()
    with rnn.step():
        xt = rnn.step_input(x)
        h_pre = rnn.memory(shape=[DH], batch_ref=x, init_value=0.0)
        xw = L.fc(xt, DH, bias_attr=False, name="rnn_xw")
        hu = L.fc(h_pre, DH, bias_attr=False, name="rnn_hu")
        h = L.tanh(L.elementwise_add(xw, hu))
        rnn.update_memory(h_pre, h)
        rnn.step_output(h)
    return rnn()


def test_static_rnn_forward_matches_numpy_and_jax():
    both = _Both(_static_rnn)
    xv = np.random.RandomState(0).randn(SEQ, BATCH, DIN).astype(np.float32)
    got, ref = both.run({"x": xv}, lambda out: [out])
    _close(got, ref)
    W = both.scope["torch"].numpy("rnn_xw.w_0")
    U = both.scope["torch"].numpy("rnn_hu.w_0")
    h = np.zeros((BATCH, DH), np.float32)
    want = []
    for t in range(SEQ):
        h = np.tanh(xv[t] @ W + h @ U)
        want.append(h)
    np.testing.assert_allclose(got[0], np.stack(want), rtol=1e-5, atol=1e-5)


def _rnn_regression(fl, L, seq=6, batch=8, din=4, dh=8):
    x = L.data("x", shape=[seq, batch, din], dtype="float32",
               append_batch_size=False)
    y = L.data("y", shape=[batch, 1], dtype="float32",
               append_batch_size=False)
    rnn = L.StaticRNN()
    with rnn.step():
        xt = rnn.step_input(x)
        h_pre = rnn.memory(shape=[dh], batch_ref=x, init_value=0.0)
        h = L.tanh(L.fc(L.concat([xt, h_pre], axis=1), dh, bias_attr=False,
                        name="cell"))
        rnn.update_memory(h_pre, h)
        rnn.step_output(h)
    hs = rnn()
    last = L.reshape(L.slice(hs, axes=[0], starts=[seq - 1], ends=[seq]),
                     [batch, dh])
    pred = L.fc(last, 1, name="head")
    loss = L.mean(L.square_error_cost(pred, y))
    fl.optimizer.Adam(1e-2).minimize(loss)
    return loss


def test_static_rnn_trains_like_jax():
    """Grads flow through the recurrent op's replay: Adam steps give the
    JAX package's losses (rtol 1e-5 for the first 10 steps), and 60 steps
    cut the loss tenfold."""
    both = _Both(_rnn_regression)
    rng = np.random.RandomState(1)
    xv = rng.randn(6, 8, 4).astype(np.float32)
    feed = {"x": xv, "y": xv[-1].sum(1, keepdims=True)}
    losses = []
    for step in range(60):
        got, ref = both.run(feed, lambda out: [out])
        if step < 10:
            _close(got, ref)
        losses.append(float(got[0].reshape(-1)[0]))
    assert losses[-1] < losses[0] * 0.1


def _beam_step(beam, k, nbk, end_id):
    def fn(fl, L):
        pre_ids = L.data("pre_ids", shape=[nbk, 1], dtype="int64",
                         append_batch_size=False)
        pre_sc = L.data("pre_sc", shape=[nbk, 1], dtype="float32",
                        append_batch_size=False)
        sc = L.data("sc", shape=[nbk, k], dtype="float32",
                    append_batch_size=False)
        blk = fl.default_main_program().global_block
        outs = [blk.create_var(name="sel_ids", shape=(nbk, 1),
                               dtype="int64"),
                blk.create_var(name="sel_sc", shape=(nbk, 1),
                               dtype="float32"),
                blk.create_var(name="par", shape=(nbk,), dtype="int64")]
        blk.append_op("beam_search",
                      inputs={"pre_ids": pre_ids, "pre_scores": pre_sc,
                              "scores": sc},
                      outputs={"selected_ids": outs[0],
                               "selected_scores": outs[1],
                               "parent_idx": outs[2]},
                      attrs={"beam_size": beam, "end_id": end_id})
        return outs
    return fn


def test_beam_search_step():
    """2 beams, known scores: the top 2 of the accumulated candidates."""
    both = _Both(_beam_step(2, 3, 2, -1))
    got, ref = both.run(
        {"pre_ids": np.array([[5], [7]], np.int64),
         "pre_sc": np.zeros((2, 1), np.float32),
         "sc": np.array([[0.6, 0.5, 0.1], [0.9, 0.3, 0.2]], np.float32)},
        lambda out: out)
    np.testing.assert_array_equal(got[0].reshape(-1), [0, 0])
    np.testing.assert_allclose(got[1].reshape(-1), [0.9, 0.6])
    np.testing.assert_array_equal(got[2], [1, 0])
    _close(got, ref)


def test_beam_search_breaks_planted_ties_like_top_k():
    """Scores on a coarse grid, so most candidates tie, and finished
    beams (pre_id == end_id) among them: the port picks what
    jax.lax.top_k picks, the lower index first on equal scores."""
    beam, k, batch = 4, 7, 6
    rng = np.random.RandomState(3)
    sc = (rng.randint(0, 3, (batch * beam, k)) * 0.5).astype(np.float32)
    pre_ids = rng.randint(0, 3, (batch * beam, 1)).astype(np.int64)
    pre_sc = (rng.randint(0, 3, (batch * beam, 1)) * 0.5).astype(np.float32)
    both = _Both(_beam_step(beam, k, batch * beam, 1))
    got, ref = both.run({"pre_ids": pre_ids, "pre_sc": pre_sc, "sc": sc},
                        lambda out: out)
    assert (pre_ids == 1).any()
    _close(got, ref)
    from paddle_tpu_torch.ops.control_flow import top_k_lowest_index_first
    import torch

    vals, pos = top_k_lowest_index_first(torch.tensor([[1.0, 2.0, 2.0, -0.5,
                                                        2.0, -0.5]]), 4)
    assert pos.tolist() == [[1, 2, 4, 0]]
    assert vals.tolist() == [[2.0, 2.0, 2.0, 1.0]]


def _decode_program(fl, L):
    arr_ids = L.create_array("int64")
    arr_sc = L.create_array("float32")
    arr_par = L.create_array("int64")
    i0 = L.fill_constant([1], "int64", 0)
    i1 = L.fill_constant([1], "int64", 1)
    L.array_write(L.assign(np.array([[11], [22]], np.int64)), i0, arr_ids)
    L.array_write(L.assign(np.array([[0.1], [0.2]], np.float32)), i0,
                  arr_sc)
    L.array_write(L.assign(np.array([0, 1], np.int64)), i0, arr_par)
    L.array_write(L.assign(np.array([[33], [44]], np.int64)), i1, arr_ids)
    L.array_write(L.assign(np.array([[0.3], [0.4]], np.float32)), i1,
                  arr_sc)
    L.array_write(L.assign(np.array([1, 1], np.int64)), i1, arr_par)
    blk = fl.default_main_program().global_block
    s_ids = blk.create_var(name="s_ids", shape=(2, 2), dtype="int64")
    s_sc = blk.create_var(name="s_sc", shape=(2, 2), dtype="float32")
    blk.append_op("beam_search_decode",
                  inputs={"Ids": arr_ids, "Scores": arr_sc,
                          "ParentIdx": arr_par},
                  outputs={"SentenceIds": s_ids, "SentenceScores": s_sc},
                  attrs={"beam_size": 2, "end_id": 0})
    return [s_ids, s_sc]


def test_beam_search_decode_backtrack():
    """Two steps whose surviving beams both descend from beam 1."""
    both = _Both(_decode_program)
    got, ref = both.run({}, lambda out: out)
    np.testing.assert_array_equal(got[0][:, 0], [22, 33])
    np.testing.assert_array_equal(got[0][:, 1], [22, 44])
    np.testing.assert_allclose(got[1][:, 1], [0.2, 0.4])
    _close(got, ref)


def test_cond_carries_side_effects():
    """Assigns to an outer var inside a branch survive, even when the
    branch returns nothing to cond."""
    def fn(fl, L):
        x = L.data("x", shape=[4], append_batch_size=False)
        acc = L.create_tensor("float32", persistable=True)
        L.assign(np.zeros(4, np.float32), acc)
        pred = L.less_than(L.reduce_sum(x),
                           L.fill_constant([1], "float32", 0.0))

        def neg():
            L.assign(x * 2.0, acc)

        def pos():
            L.assign(x * 3.0, acc)

        assert L.cond(pred, neg, pos) is None
        return acc + 1.0

    both = _Both(fn)
    xv = np.array([1.0, 2.0, 3.0, 4.0], np.float32)
    for feed_x, scale in ((xv, 3.0), (-xv, 2.0)):
        got, ref = both.run({"x": feed_x}, lambda out: [out])
        np.testing.assert_allclose(got[0], feed_x * scale + 1.0, rtol=1e-6)
        _close(got, ref)


def test_conditional_block_shape_mismatch_clear_error():
    """Reshaping an outer var inside a branch raises an error naming the
    conditional_block output, in both packages."""
    def fn(fl, L):
        x = L.data("x", shape=[4], append_batch_size=False)
        y = L.create_tensor("float32", persistable=True)
        L.assign(np.zeros(4, np.float32), y)
        pred = L.less_than(L.reduce_sum(x),
                           L.fill_constant([1], "float32", 0.0))

        def bad_branch():
            L.assign(L.reshape(x, [2, 2]), y)

        L.cond(pred, bad_branch, None)
        return L.reduce_sum(x)

    for pkg in PKGS:
        fl = PKGS[pkg][0]
        main, startup, out = _build(pkg, fn)
        exe, scope = fl.Executor(fl.CPUPlace()), fl.Scope()
        exe.run(startup, scope=scope)
        with pytest.raises(Exception, match="conditional_block output"):
            exe.run(main, feed={"x": np.ones(4, np.float32)},
                    fetch_list=[out], scope=scope)


# -- the While gradient (tests/test_while_grad.py) ---------------------------

T, D, H, B = 5, 4, 8, 16


def _while_rnn(max_len=T, n_feed=False, optimize=True):
    def fn(fl, L):
        ParamAttr = fl.ParamAttr
        x = L.data("x", shape=[T, B, D], append_batch_size=False)
        y = L.data("y", shape=[B, 1], append_batch_size=False)
        n = (L.data("n", shape=[1], dtype="int64", append_batch_size=False)
             if n_feed else L.fill_constant([1], "int64", T))
        i = L.fill_constant([1], "int64", 0)
        h = L.fill_constant([B, H], "float32", 0.0)
        cond = L.less_than(i, n)
        w = L.While(cond, max_len=max_len)
        with w.block():
            xt = L.squeeze(L.gather(x, i), axes=[0])
            nh = L.tanh(L.fc(L.concat([xt, h], axis=1), H, bias_attr=False,
                             param_attr=ParamAttr(name="cell_w"),
                             name="cell"))
            L.assign(nh, h)
            L.increment(i, value=1)
            L.assign(L.less_than(i, n), cond)
        pred = L.fc(h, 1, param_attr=ParamAttr(name="out_w"),
                    bias_attr=False, name="out")
        loss = L.mean(L.square_error_cost(pred, y))
        if optimize:
            fl.optimizer.SGD(0.1).minimize(loss)
        return loss
    return fn


def _static_rnn_sgd(steps=T):
    def fn(fl, L):
        ParamAttr = fl.ParamAttr
        x = L.data("x", shape=[steps, B, D], append_batch_size=False)
        y = L.data("y", shape=[B, 1], append_batch_size=False)
        rnn = L.StaticRNN()
        with rnn.step():
            xt = rnn.step_input(x)
            hp = rnn.memory(shape=[H], batch_ref=x)
            nh = L.tanh(L.fc(L.concat([xt, hp], axis=1), H, bias_attr=False,
                             param_attr=ParamAttr(name="cell_w"),
                             name="cell"))
            rnn.update_memory(hp, nh)
            rnn.step_output(nh)
        h = L.squeeze(L.slice(rnn(), axes=[0], starts=[steps - 1],
                              ends=[steps]), axes=[0])
        pred = L.fc(h, 1, param_attr=ParamAttr(name="out_w"),
                    bias_attr=False, name="out")
        loss = L.mean(L.square_error_cost(pred, y))
        fl.optimizer.SGD(0.1).minimize(loss)
        return loss
    return fn


RNG = np.random.RandomState(0)
XB = RNG.randn(T, B, D).astype(np.float32)
YB = RNG.randn(B, 1).astype(np.float32)


def _train(both, feed, steps=8):
    losses = {"torch": [], "jax": []}
    for _ in range(steps):
        got, ref = both.run(feed, lambda out: [out])
        _close(got, ref)
        losses["torch"].append(float(got[0].reshape(-1)[0]))
        losses["jax"].append(float(ref[0].reshape(-1)[0]))
    return losses["torch"]


def _torch_train(fn, feed, init, steps=8):
    main, startup, loss = _build("torch", fn)
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    exe.run(startup, scope=scope)
    scope_from_numpy(init, scope, tfluid.CPUPlace(), programs=[main])
    return [float(exe.run(main, feed=feed, fetch_list=[loss],
                          scope=scope)[0].reshape(-1)[0])
            for _ in range(steps)]


def _init(both):
    return {n: both.scope["torch"].numpy(n) for n in ("cell_w", "out_w")}


def test_while_rnn_trains_like_static_rnn_and_jax():
    """A While-RNN's SGD steps give the JAX package's losses (rtol 1e-5)
    and the same cell written as a StaticRNN's (rtol 1e-4, as the
    reference's test holds them)."""
    both = _Both(_while_rnn())
    init = _init(both)
    lw = _train(both, {"x": XB, "y": YB})
    ls = _torch_train(_static_rnn_sgd(), {"x": XB, "y": YB}, init)
    np.testing.assert_allclose(lw, ls, rtol=1e-4, atol=1e-6)
    assert lw[-1] < lw[0]


def test_while_rnn_dynamic_trip_count():
    """A trip count fed at run time (3 < max_len 5): the grads cover the
    3 trips run, as a StaticRNN over x[:3]; the JAX package agrees."""
    n = np.array([3], np.int64)
    both = _Both(_while_rnn(n_feed=True))
    init = _init(both)
    lw = _train(both, {"x": XB, "y": YB, "n": n})
    ls = _torch_train(_static_rnn_sgd(steps=3), {"x": XB[:3], "y": YB},
                      init)
    np.testing.assert_allclose(lw, ls, rtol=1e-4, atol=1e-6)


def test_while_grad_equals_the_jax_vjp():
    """calc_gradient through a While: d loss / d x and d loss / d cell_w
    equal the JAX package's (its masked scan under jax.vjp)."""
    def fn(fl, L):
        loss = _while_rnn(optimize=False)(fl, L)
        blk = fl.default_main_program().global_block
        x, w = blk.var("x"), blk.var("cell_w")
        x.stop_gradient = False
        return fl.gradients([loss], [x, w]) + [loss]

    both = _Both(fn)
    got, ref = both.run({"x": XB, "y": YB}, lambda out: out)
    assert got[0].shape == (T, B, D) and np.abs(got[1]).max() > 0
    _close(got, ref)


def test_while_grad_requires_max_len():
    """Without max_len the grad is refused with the reference's message,
    in both packages."""
    def fn(fl, L):
        x = L.data("x", shape=[4], dtype="float32")
        i = L.fill_constant([1], "int64", 0)
        n = L.fill_constant([1], "int64", 3)
        h = L.fc(x, 4, name="f")
        cond = L.less_than(i, n)
        w = L.While(cond)
        with w.block():
            L.assign(L.scale(h, scale=2.0), h)
            L.increment(i, value=1)
            L.assign(L.less_than(i, n), cond)
        loss = L.mean(h)
        fl.optimizer.SGD(0.1).minimize(loss)
        return loss

    for pkg in PKGS:
        fl = PKGS[pkg][0]
        main, startup, loss = _build(pkg, fn)
        exe, scope = fl.Executor(fl.CPUPlace()), fl.Scope()
        exe.run(startup, scope=scope)
        with pytest.raises(Exception, match=(
                r"differentiating a While requires a static iteration "
                r"bound: construct it as layers.While\(cond, max_len=N\)")):
            exe.run(main, feed={"x": np.ones((2, 4), np.float32)},
                    fetch_list=[loss], scope=scope)


def test_while_max_len_bounds_forward_and_backward():
    """A condition that outlives max_len: the forward and the grad both
    stop at max_len (h = (2^2)^2 = 16, dh/dx = 4 x^3 = 32)."""
    def fn(fl, L):
        x = L.data("x", shape=[1], append_batch_size=False,
                   stop_gradient=False)
        i = L.fill_constant([1], "int64", 0)
        n = L.fill_constant([1], "int64", 4)
        h = L.assign(x)
        cond = L.less_than(i, n)
        w = L.While(cond, max_len=2)
        with w.block():
            L.assign(L.elementwise_mul(h, h), h)
            L.increment(i, value=1)
            L.assign(L.less_than(i, n), cond)
        loss = L.mean(h)
        (gx,) = fl.gradients([loss], [x])
        return [loss, gx]

    both = _Both(fn)
    tcf.reset_cond_reads()
    got, ref = both.run({"x": np.array([2.0], np.float32)}, lambda out: out)
    assert float(got[0]) == 16.0 and float(got[1].reshape(-1)[0]) == 32.0
    assert tcf.cond_reads() == 2      # the bound stops the third
    _close(got, ref)


# -- refusals of the port ----------------------------------------------------

def test_while_refuses_a_carry_that_changes_shape():
    """A body that reshapes a carried var is refused, naming the var."""
    def fn(fl, L):
        x = L.data("x", shape=[4], append_batch_size=False)
        i = L.fill_constant([1], "int64", 0)
        n = L.fill_constant([1], "int64", 2)
        h = L.assign(x)
        cond = L.less_than(i, n)
        w = L.While(cond, max_len=2)
        with w.block():
            L.assign(L.concat([h, h], axis=0), h)
            L.increment(i, value=1)
            L.assign(L.less_than(i, n), cond)
        return h

    main, startup, h = _build("torch", fn)
    exe = tfluid.Executor(tfluid.CPUPlace())
    with pytest.raises(Exception, match=f"carried var '{h.name}'"):
        exe.run(main, feed={"x": np.ones(4, np.float32)}, fetch_list=[h],
                scope=tfluid.Scope())


def _overflow(fl, L):
    i = L.fill_constant([1], "int64", 0)
    n = L.fill_constant([1], "int64", 3)
    arr = L.create_array("float32")
    L.array_write(L.fill_constant([1], "float32", -1.0), i, arr)
    cond = L.less_than(i, n)
    w = L.While(cond, max_len=3)
    with w.block():
        # writes at 1, 2, 3: the last is past the capacity 3
        L.increment(i, value=1)
        L.array_write(L.cast(i, "float32"), i, arr)
        L.assign(L.less_than(i, n), cond)
    return arr, L.tensor_array_to_tensor(arr), L.array_length(arr)


def test_tensor_array_write_past_capacity():
    """A difference by design: the JAX package clamps a write at index 3
    of a capacity-3 array into the last row (and counts 4 entries); the
    port refuses it, naming the array, the index and the capacity."""
    jmain, jstartup, (jarr, jstack, jlen) = _build("jax", _overflow)
    stacked, length = fluid.Executor(fluid.CPUPlace()).run(
        jmain, fetch_list=[jstack, jlen], scope=fluid.Scope())
    np.testing.assert_array_equal(np.asarray(stacked)[:, 0],
                                  [-1.0, 1.0, 3.0])
    assert int(np.asarray(length)[0]) == 4
    main, startup, (arr, stack, ln) = _build("torch", _overflow)
    with pytest.raises(Exception, match=(
            f"tensor array '{arr.name}': write at index 3 past its "
            f"capacity 3")):
        tfluid.Executor(tfluid.CPUPlace()).run(
            main, fetch_list=[stack, ln], scope=tfluid.Scope())


def test_list_mode_write_at_a_written_index():
    """A difference by design: outside a loop, a second write at index 0
    overwrites the entry in the port (the reference's LoDTensorArray, and
    what the JAX package's rule does for a concrete index), while the JAX
    package's executor, whose indices are traced, appends it."""
    def fn(fl, L):
        arr = L.create_array("float32")
        i = L.fill_constant([1], "int64", 0)
        L.array_write(L.fill_constant([2], "float32", 1.0), i, arr)
        L.array_write(L.fill_constant([2], "float32", 2.0), i, arr)
        return [L.array_length(arr), L.tensor_array_to_tensor(arr)]

    got, ref = _Both(fn).run({}, lambda out: out)
    assert got[0].tolist() == [1] and got[1].tolist() == [[2.0, 2.0]]
    assert ref[0].tolist() == [2]
    assert ref[1].tolist() == [[1.0, 1.0], [2.0, 2.0]]


def test_sparse_lookup_table_v2_grad_is_refused():
    """``lookup_table_v2(is_sparse=True)``'s grad, refused until the port
    had SelectedRows, is now the JAX package's: a SelectedRows of the
    step's 6 lookups over a table of 10 rows whose dense form equals the
    reference's (ids repeated, one out of range and clamped)."""
    feed = {"ids": np.array([[3, 3, 9], [0, 12, 3]], np.int64)}
    got = {}
    for pkg, fl in (("jax", fluid), ("torch", tfluid)):
        main, startup = fl.Program(), fl.Program()
        with fl.program_guard(main, startup):
            ids = fl.layers.data("ids", shape=[3], dtype="int64")
            w = fl.layers.create_global_var([10, 4], 0.5, "float32",
                                            persistable=True, name="w")
            w.stop_gradient = False
            out = main.global_block.create_var(name="emb", dtype="float32")
            main.global_block.append_op("lookup_table_v2",
                                        inputs={"W": w, "Ids": ids},
                                        outputs={"Out": out},
                                        attrs={"is_sparse": True})
            (gw,) = fl.gradients([fl.layers.reduce_sum(
                fl.layers.scale(out, scale=2.0))], [w])
        exe, scope = fl.Executor(fl.CPUPlace()), fl.Scope()
        exe.run(startup, scope=scope)
        got[pkg] = exe.run(main, feed=feed, fetch_list=[gw], scope=scope,
                           return_numpy=False)[0]
    t, j = got["torch"], got["jax"]
    assert t.height == j.height == 10 and tuple(t.values.shape) == (6, 4)
    np.testing.assert_array_equal(t.rows.numpy(),
                                  np.asarray(j.rows).astype(np.int64))
    np.testing.assert_allclose(t.to_dense().numpy(),
                               np.asarray(j.to_dense()), rtol=1e-6)


def test_fetching_a_tensor_array_names_it():
    """A tensor array is not a tensor: fetching one raises a TypeError
    naming the var and the way to stack it."""
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        L = tfluid.layers
        arr = L.create_array("float32")
        L.array_write(L.fill_constant([2], "float32", 1.0),
                      L.fill_constant([1], "int64", 0), arr)
    with pytest.raises(TypeError, match=f"fetch '{arr.name}' is a "
                                        f"TensorArray"):
        tfluid.Executor(tfluid.CPUPlace()).run(main, fetch_list=[arr],
                                               scope=tfluid.Scope())
