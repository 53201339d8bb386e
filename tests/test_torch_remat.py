"""Gradient checkpointing in the PyTorch port against the JAX package's, on
the CPU: the cases of ``tests/test_auto_remat.py`` and
``tests/test_recompute.py`` that inspect no XLA artefact.

* The auto-remat decision (``analysis.remat.auto_recompute_program``:
  applied, reason, segments, candidates, checkpoints, predicted peaks
  before and after, budget trials) is equal to the JAX package's on the
  same programs, each built in both packages under
  ``unique_name.guard()`` (the JAX package declares int64 feeds int32, so
  the port program is planned with the JAX program's declared dtypes).
* Remat training against plain training (``FLAGS_auto_recompute`` off and
  on, ``run`` and ``run_chained``), manual ``RecomputeOptimizer`` against
  plain, dropout inside a segment, a fetched intermediate: losses within
  ``REMAT_RTOL`` (measured: bit-identical). The replay recomputes the
  same ops on the same inputs with the same generators; each reader of a
  segment input has a leaf of its own and an op with a grad rule replays
  through it, so the gradients are the plain program's bit for bit:
  BERT-tiny's (float32, dropout 0) are asserted equal, on one CPU thread
  (the CPU's accumulating ``index_put_`` adds with atomics across
  threads).
* Inference and startup programs pass through, manual
  ``RecomputeOptimizer`` programs are refused, a changed fetch list gets
  its own transform, the remat program gets its own executor key.
* BERT-tiny under remat in both packages from the JAX package's initial
  scope, three Adam steps (lr 1e-4). Float32: losses within rtol 1e-4 and
  every parameter, Adam moment and beta power within atol 1e-6 / rtol
  1e-4 (``tests/test_torch_bert.py``'s tolerances; measured up to 2.3e-7).
  ``amp=True``: losses within the AMP tests' bf16 rtol 1e-3; XLA and
  PyTorch round bf16 products differently, so a near-zero gradient can
  change sign and Adam moves that weight by up to lr the other way: every
  element within 2 * lr * 3 steps = 6e-4 (measured up to 3.1e-4, the
  same with remat off), and at most 1 % of all state elements outside
  atol 1e-5 / rtol 1e-3 (measured 0.14 %).
"""
import dataclasses

import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu.unique_name as jun
from paddle_tpu.analysis.remat import auto_recompute_program as j_decide
from paddle_tpu.analysis.remat import remat_candidates as j_candidates
from paddle_tpu.models.bert import BertConfig as JBertConfig
from paddle_tpu.models.bert import build_bert_pretrain as j_bert

import paddle_tpu_torch as tfluid
import paddle_tpu_torch.unique_name as tun
from paddle_tpu_torch import kernels as K
from paddle_tpu_torch import monitor as tmonitor
from paddle_tpu_torch.analysis.remat import \
    auto_recompute_program as t_decide
from paddle_tpu_torch.analysis.remat import remat_candidates as t_candidates
from paddle_tpu_torch.interop import scope_from_numpy
from paddle_tpu_torch.models.bert import BertConfig as TBertConfig
from paddle_tpu_torch.models.bert import build_bert_pretrain as t_bert

WIDTH, DEPTH, BATCH = 128, 8, 256
# remat against plain, float32 losses over three steps (module docstring)
REMAT_RTOL = 1e-6
# BERT-tiny under remat, port against the JAX package (module docstring)
LOSS_RTOL = {False: 1e-4, True: 1e-3}
F32_STATE_TOL = dict(atol=1e-6, rtol=1e-4)
BF16_STATE_BOUND = 2 * 1e-4 * 3
BF16_STATE_TOL = dict(atol=1e-5, rtol=1e-3)
BF16_STATE_OUTSIDE = 1e-2
SEQ = 32

PKGS = {"jax": (jfluid, jun), "torch": (tfluid, tun)}


@pytest.fixture(autouse=True)
def _flags():
    names = ["FLAGS_auto_recompute", "FLAGS_remat_budget_mb"]
    prev = tfluid.get_flags(names)
    jprev = jfluid.get_flags(names)
    yield
    tfluid.set_flags(prev)
    jfluid.set_flags(jprev)


def _build(pkg="torch", width=WIDTH, depth=DEPTH, seed=11, dropout=0.0):
    fluid, un = PKGS[pkg]
    with un.guard():
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            x = fluid.layers.data("x", shape=[width], dtype="float32")
            y = fluid.layers.data("y", shape=[1], dtype="int64")
            h = x
            acts = []
            for _ in range(depth):
                h = fluid.layers.fc(h, width, act="relu")
                if dropout:
                    h = fluid.layers.dropout(h, dropout)
                acts.append(h.name)
            loss = fluid.layers.mean(
                fluid.layers.softmax_with_cross_entropy(
                    fluid.layers.fc(h, 4), y))
            fluid.optimizer.Adam(learning_rate=0.01).minimize(loss)
    main.random_seed = seed
    return main, startup, loss, acts


def _feed(width=WIDTH, batch=BATCH):
    rng = np.random.RandomState(0)
    return {"x": rng.randn(batch, width).astype(np.float32),
            "y": rng.randint(0, 4, (batch, 1)).astype(np.int64)}


def _declare_as(tprog, jprog):
    """Give the port program's vars the JAX program's declared dtypes."""
    for tb, jb in zip(tprog.blocks, jprog.blocks):
        for n, v in tb.vars.items():
            jv = jb.vars.get(n)
            if jv is not None and str(jv.dtype) != v.dtype:
                v.dtype = str(jv.dtype)


def _segments(prog):
    return sum(op.type == "recompute_segment"
               for op in prog.global_block.ops)


def _ran(exe, main):
    return next((p for k, p in exe._remat_cache.items()
                 if k[0][0] == main._serial), main)


def _train(auto, chained=False, steps=4, fetch_extra=None, dropout=0.0):
    main, startup, loss, acts = _build(dropout=dropout)
    tfluid.set_flags({"FLAGS_auto_recompute": auto})
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    feed = _feed()
    fetches = [loss.name] + (fetch_extra(acts) if fetch_extra else [])
    exe.run(startup, scope=scope)
    if chained:
        outs = exe.run_chained(main, feed=feed, fetch_list=fetches,
                               steps=steps, scope=scope)
        out = np.asarray(outs[0]).reshape(-1)
        extra = outs[1:]
    else:
        runs = [exe.run(main, feed=feed, fetch_list=fetches, scope=scope)
                for _ in range(steps)]
        out = np.array([float(r[0].reshape(-1)[0]) for r in runs])
        extra = runs[-1][1:]
    ran = _ran(exe, main)
    return out, _segments(ran), exe, main, ran, extra


def _close(a, b):
    np.testing.assert_allclose(a, b, rtol=REMAT_RTOL, atol=0)


# ---------------------------------------------------------------------------
# the decision against the JAX package's
# ---------------------------------------------------------------------------

def test_candidates_match_jax():
    jm = _build("jax")[0]
    tm = _build("torch")[0]
    jc = j_candidates(jm, batch_size=BATCH)
    tc = t_candidates(tm, batch_size=BATCH)
    assert len(tc) >= DEPTH
    assert [dataclasses.astuple(c) for c in tc] == \
        [dataclasses.astuple(c) for c in jc]


@pytest.mark.parametrize("budget", ["none", "between", "roomy"])
def test_mlp_decision_matches_jax(budget):
    jm, _, jl, _ = _build("jax")
    tm, _, tl, _ = _build("torch")
    free = t_decide(tm, ["x", "y"], [tl.name], BATCH)
    mb = {"none": 0,
          "between": max(1, (free.peak_after >> 20) + 1
                         + ((free.peak_before - free.peak_after) >> 21)),
          "roomy": (free.peak_before >> 20) + 64}[budget]
    td = t_decide(tm, ["x", "y"], [tl.name], BATCH, budget_mb=mb)
    jd = j_decide(jm, ["x", "y"], [jl.name], BATCH, budget_mb=mb)
    assert td.to_dict() == jd.to_dict()
    assert td.applied == (budget != "roomy")


def test_bert_tiny_amp_decision_matches_jax():
    with jun.guard():
        j = j_bert(JBertConfig.tiny(), seq_len=SEQ, amp=True)
    with tun.guard():
        t = t_bert(TBertConfig.tiny(), seq_len=SEQ, amp=True)
    _declare_as(t["main"], j["main"])
    feeds = sorted(t["feeds"])
    jd = j_decide(j["main"], feeds, [j["loss"].name], 8)
    td = t_decide(t["main"], feeds, [t["loss"].name], 8)
    assert td.applied and td.n_segments > 0
    assert td.peak_after < td.peak_before
    assert td.to_dict() == jd.to_dict()
    assert _segments(td.program) == _segments(jd.program) == td.n_segments


# ---------------------------------------------------------------------------
# remat training against plain training (test_auto_remat.py's cases)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("chained", [False, True])
def test_auto_remat_matches_plain(chained):
    plain, seg0, _, _, _, _ = _train(False, chained=chained)
    remat, seg1, _, _, _, _ = _train(True, chained=chained)
    assert seg0 == 0 and seg1 > 0
    _close(remat, plain)
    assert plain[0] != plain[-1]          # parameters actually moved


def test_predicted_peak_drops():
    _, segs, _, main, ran, _ = _train(True, steps=1)
    assert segs > 0 and ran is not main and ran._serial != main._serial
    kw = dict(feed_names=["x", "y"], batch_size=BATCH)
    assert ran.memory_plan(**kw).peak_bytes < \
        main.memory_plan(**kw).peak_bytes


def test_budget_respected():
    main, _, loss, _ = _build()
    free = t_decide(main, ["x", "y"], [loss.name], BATCH)
    assert free.applied and free.n_segments > 0
    budget_mb = max(1, (free.peak_after >> 20) + 1 +
                    ((free.peak_before - free.peak_after) >> 21))
    dec = t_decide(main, ["x", "y"], [loss.name], BATCH,
                   budget_mb=budget_mb)
    assert dec.applied and dec.peak_after <= budget_mb << 20
    assert len(dec.checkpoints) >= len(free.checkpoints)
    roomy = t_decide(main, ["x", "y"], [loss.name], BATCH,
                     budget_mb=(free.peak_before >> 20) + 64)
    assert not roomy.applied and "already fits" in roomy.reason


def test_inference_and_startup_programs_pass_through():
    main, startup, loss, _ = _build()
    infer = main.clone(for_test=True)
    tfluid.set_flags({"FLAGS_auto_recompute": 1})
    exe = tfluid.Executor(tfluid.CPUPlace())
    assert exe._maybe_auto_remat(infer, _feed(), [loss.name]) is infer
    assert exe._maybe_auto_remat(startup, {}, []) is startup
    dec = t_decide(infer, ["x", "y"], [loss.name], BATCH)
    assert not dec.applied and "no backward" in dec.reason
    # startup runs through the executor with the flag on, unchanged
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    assert not exe._remat_decisions


def _manual_program(pkg, width=32, depth=4, ckpt_every=2, recompute=True):
    fluid, un = PKGS[pkg]
    with un.guard():
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            x = fluid.layers.data("x", shape=[width], dtype="float32")
            y = fluid.layers.data("y", shape=[1], dtype="int64")
            h = x
            ckpts = []
            for i in range(depth):
                h = fluid.layers.fc(h, width, act="relu")
                if (i + 1) % ckpt_every == 0:
                    ckpts.append(h)
            loss = fluid.layers.mean(
                fluid.layers.softmax_with_cross_entropy(
                    fluid.layers.fc(h, 4), y))
            opt = fluid.optimizer.Adam(learning_rate=0.01)
            if recompute:
                opt = fluid.optimizer.RecomputeOptimizer(opt)
                opt._set_checkpoints(ckpts)
            opt.minimize(loss)
    main.random_seed = 7
    return main, startup, loss


def test_manual_recompute_program_refused():
    main, _, loss = _manual_program("torch")
    dec = t_decide(main, ["x", "y"], [loss.name], 64)
    assert not dec.applied and "recompute segments" in dec.reason


def test_run_chained_cache_separation():
    """One executor, the same program, the flag flipped between
    dispatches: the remat variant gets its own executor key (its own
    program serial)."""
    main, startup, loss, _ = _build()
    exe = tfluid.Executor(tfluid.CPUPlace())
    feed = _feed()

    def chained(auto):
        tfluid.set_flags({"FLAGS_auto_recompute": auto})
        scope = tfluid.Scope()
        # startup on a fresh executor: the shared one's seed counter
        # advances per dispatch
        tfluid.Executor(tfluid.CPUPlace()).run(startup, scope=scope)
        outs = exe.run_chained(main, feed=feed, fetch_list=[loss.name],
                               steps=4, scope=scope)
        return np.asarray(outs[0]).reshape(-1)

    plain = chained(False)
    remat = chained(True)
    _close(remat, plain)
    serials = {k[1][0] for k in exe._cache if k[0] == "chained"}
    assert main._serial in serials and len(serials) == 2


def test_fetching_intermediate_survives_auto_remat():
    def fetch_mid(acts):
        return [acts[len(acts) // 2]]

    plain, _, _, _, _, pmid = _train(False, fetch_extra=fetch_mid)
    remat, segs, _, _, ran, rmid = _train(True, fetch_extra=fetch_mid)
    assert segs > 0
    _close(remat, plain)
    np.testing.assert_allclose(rmid[0], pmid[0], rtol=REMAT_RTOL)
    # kept as a segment output at the top level, never demoted
    mid = fetch_mid(_build()[3])[0]
    assert ran.global_block.has_var(mid)


def test_remat_dropout_replays():
    """Dropout inside a segment draws the same mask in the replay (the
    generator is keyed on the step seed and the op's uid)."""
    plain, _, _, _, _, _ = _train(False, dropout=0.3)
    remat, segs, _, _, ran, _ = _train(True, dropout=0.3)
    assert segs > 0
    assert any(op.type == "dropout" for b in ran.blocks[1:] for op in b.ops)
    _close(remat, plain)


def test_changed_fetch_list_gets_its_own_transform():
    main, startup, loss, acts = _build()
    tfluid.set_flags({"FLAGS_auto_recompute": 1})
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    feed = _feed()
    mid = acts[len(acts) // 2]
    exe.run(startup, scope=scope)
    exe.run(main, feed=feed, fetch_list=[loss.name], scope=scope)
    _, mid_val = exe.run(main, feed=feed, fetch_list=[loss.name, mid],
                         scope=scope)
    assert np.isfinite(mid_val).all() and mid_val.shape == (BATCH, WIDTH)
    assert len({k[3] for k in exe._remat_cache
                if k[0][0] == main._serial}) == 2


def test_remat_decisions_are_counted():
    tmonitor.reset()
    _train(True, steps=1)
    assert tmonitor.metric_value("remat_programs_total", 0.0,
                                 outcome="applied") == 1.0
    assert tmonitor.metric_value("remat_segments_inserted_total", 0.0) > 0
    assert tmonitor.metric_value("remat_predicted_peak_bytes", 0.0,
                                 variant="remat") < \
        tmonitor.metric_value("remat_predicted_peak_bytes", 0.0,
                              variant="plain")


# ---------------------------------------------------------------------------
# manual RecomputeOptimizer (test_recompute.py's cases)
# ---------------------------------------------------------------------------

def _run_manual(recompute, steps=4):
    main, startup, loss = _manual_program("torch", recompute=recompute)
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    rng = np.random.RandomState(0)
    feed = {"x": rng.randn(16, 32).astype(np.float32),
            "y": rng.randint(0, 4, (16, 1)).astype(np.int64)}
    exe.run(startup, scope=scope)
    return np.array([float(exe.run(main, feed=feed, fetch_list=[loss],
                                   scope=scope)[0].reshape(-1)[0])
                     for _ in range(steps)])


def test_recompute_matches_plain_training():
    base = _run_manual(False)
    rc = _run_manual(True)
    _close(rc, base)
    assert base[-1] < base[0]


def test_recompute_program_matches_jax():
    """Segments inserted, internals demoted into the sub-blocks, and the
    whole program (segment ops, their grads and sub-blocks) equal to the
    JAX package's."""
    tmain = _manual_program("torch", depth=6)[0]
    jmain = _manual_program("jax", depth=6)[0]
    types = [op.type for op in tmain.global_block.ops]
    assert types.count("recompute_segment") >= 2
    assert types.count("recompute_segment_grad") >= 2
    sub = tmain.blocks[tmain.global_block.ops[
        types.index("recompute_segment")].attrs["sub_block"]]
    assert sub.ops and sub.vars

    def norm(prog):
        d = prog.to_dict()
        for b in d["blocks"]:
            for v in b["vars"]:
                if v["dtype"] == "int32":
                    v["dtype"] = "int64"
            for o in b["ops"]:
                o["attrs"].pop("op_callstack", None)
        return d

    assert norm(tmain) == norm(jmain)


def test_recompute_program_serializes_and_runs():
    main, startup, loss = _manual_program("torch")
    clone = tfluid.Program.from_json(main.to_json())
    rng = np.random.RandomState(1)
    feed = {"x": rng.randn(8, 32).astype(np.float32),
            "y": rng.randint(0, 4, (8, 1)).astype(np.int64)}
    vals = []
    for prog in (main, clone):
        exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
        exe.run(startup, scope=scope)
        vals.append(exe.run(prog, feed=feed, fetch_list=[loss.name],
                            scope=scope)[0])
    assert vals[0].tobytes() == vals[1].tobytes()


# ---------------------------------------------------------------------------
# BERT-tiny amp=True
# ---------------------------------------------------------------------------

def _bert_feed(batch=4):
    rng = np.random.RandomState(0)
    lens = np.array([[32], [28], [20], [32]])[:batch]
    return {
        "src_ids": rng.randint(0, 1024, (batch, SEQ)).astype(np.int64),
        "pos_ids": np.tile(np.arange(SEQ), (batch, 1)).astype(np.int64),
        "sent_ids": (np.arange(SEQ)[None] >= 16).astype(np.int64)
        .repeat(batch, 0),
        "input_mask": (np.arange(SEQ)[None] < lens).astype(np.float32),
        "mask_label": np.where(rng.rand(batch, SEQ) < 0.15,
                               rng.randint(0, 1024, (batch, SEQ)),
                               -100).astype(np.int64),
        "next_sent_label": rng.randint(0, 2, (batch, 1)).astype(np.int64)}


def test_bert_tiny_amp_remat_matches_plain():
    """Embeddings with tied weights, attention (dropout 0.1), layer_norm,
    the AMP policy: remat losses match plain over three steps, with the
    attention ops' replays inside the segments."""
    feed = _bert_feed()

    def run(auto):
        with tun.guard():
            m = t_bert(TBertConfig.tiny(), seq_len=SEQ, amp=True)
        m["main"].random_seed = 3
        tfluid.set_flags({"FLAGS_auto_recompute": auto})
        exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
        exe.run(m["startup"], scope=scope)
        K.reset_launch_counts()
        out = [float(exe.run(m["main"], feed=feed,
                             fetch_list=[m["loss"]], scope=scope)[0][0])
               for _ in range(3)]
        return np.array(out), _ran(exe, m["main"]), m["main"]

    plain, _, _ = run(False)
    remat, ran, main = run(True)
    assert _segments(ran) > 0
    assert any(op.type == "fused_multihead_attention"
               for b in ran.blocks[1:] for op in b.ops)
    _close(remat, plain)
    assert set(K.launch_counts().values()) == {0}       # CPU: no kernels
    kw = dict(feed_names=sorted(feed), batch_size=4)
    assert ran.memory_plan(**kw).peak_bytes < \
        main.memory_plan(**kw).peak_bytes


@pytest.mark.parametrize("amp", [False, True])
def test_bert_tiny_remat_state_matches_jax(amp):
    """Both packages under FLAGS_auto_recompute from the JAX package's
    initial scope (dropout off): the same number of segments, the losses
    and, after three steps, every parameter, Adam moment and beta power
    held against the JAX package's (module docstring)."""
    cfg = dict(hidden_dropout=0.0, attention_dropout=0.0)
    with jun.guard():
        j = j_bert(dataclasses.replace(JBertConfig.tiny(), **cfg),
                   seq_len=SEQ, amp=amp)
    with tun.guard():
        t = t_bert(dataclasses.replace(TBertConfig.tiny(), **cfg),
                   seq_len=SEQ, amp=amp)
    jexe, jscope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    jexe.run(j["startup"], scope=jscope)
    names = [v.name for v in j["startup"].global_block.vars.values()]
    state = {n: jscope.numpy(n) for n in names}
    texe, tscope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    scope_from_numpy(state, tscope, tfluid.CPUPlace(), programs=[t["main"]])
    jfluid.set_flags({"FLAGS_auto_recompute": 1})
    tfluid.set_flags({"FLAGS_auto_recompute": 1})
    feed = _bert_feed()
    for step in range(3):
        jl = jexe.run(j["main"], feed=feed, fetch_list=[j["loss"]],
                      scope=jscope)
        tl = texe.run(t["main"], feed=feed, fetch_list=[t["loss"]],
                      scope=tscope)
        np.testing.assert_allclose(tl[0], jl[0], rtol=LOSS_RTOL[amp],
                                   err_msg=f"step {step}")
    jran = next(iter(jexe._remat_cache.values()))
    tran = next(iter(texe._remat_cache.values()))
    assert _segments(tran) == _segments(jran) > 0
    n_outside = n_total = 0
    for n in names:
        got, want = tscope.numpy(n), np.asarray(jscope.numpy(n))
        if not amp:
            np.testing.assert_allclose(got, want, err_msg=n,
                                       **F32_STATE_TOL)
            continue
        diff = np.abs(got - want)
        assert diff.max() <= BF16_STATE_BOUND, n
        n_outside += int((diff > BF16_STATE_TOL["atol"] + BF16_STATE_TOL[
            "rtol"] * np.abs(want)).sum())
        n_total += diff.size
    assert n_outside <= BF16_STATE_OUTSIDE * n_total


def test_bert_tiny_remat_gradients_equal_plain_bit_for_bit():
    """BERT-tiny float32 at dropout 0, one step from one state: every
    parameter's gradient under FLAGS_auto_recompute equals the plain
    program's bit for bit, with segments whose inputs are read by several
    ops (the encoder input: Q, K and V inside a segment, the residual add
    outside it)."""
    import torch

    feed = _bert_feed()
    cfg = dataclasses.replace(TBertConfig.tiny(), hidden_dropout=0.0,
                              attention_dropout=0.0)
    with tun.guard():
        m = t_bert(cfg, seq_len=SEQ)
    grads = sorted(v.name + "@GRAD" for v in
                   m["main"].global_block.vars.values()
                   if type(v).__name__ == "Parameter")
    init = tfluid.Scope()
    tfluid.Executor(tfluid.CPUPlace()).run(m["startup"], scope=init)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)

    def run(auto):
        tfluid.set_flags({"FLAGS_auto_recompute": auto})
        exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
        for n, t in init.vars.items():
            scope.set_var(n, t.clone())
        out = exe.run(m["main"], feed=feed, fetch_list=grads, scope=scope)
        return out, _ran(exe, m["main"])

    try:
        plain, _ = run(False)
        remat, ran = run(True)
    finally:
        torch.set_num_threads(threads)
    assert _segments(ran) > 0
    seg_inputs = [n for op in ran.global_block.ops
                  if op.type == "recompute_segment"
                  for n in op.inputs["Input"]]
    readers = [sum(n in op.input_arg_names for op in b.ops)
               for n in seg_inputs for b in ran.blocks[1:]]
    assert max(readers) > 1
    for name, a, b in zip(grads, plain, remat):
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes(), name


def test_remat_replay_leaves_no_tensor_in_a_reference_cycle():
    """A segment's replay runs ops with a grad rule through an autograd
    Function; its outputs must not hold their own grad_fn's context, or
    each step's activations live on until the cyclic collector runs (the
    card's held memory grew 757.4 MiB over two BERT-base steps)."""
    import gc
    import warnings

    import torch

    feed = _bert_feed()
    with tun.guard():
        m = t_bert(TBertConfig.tiny(), seq_len=SEQ)
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    exe.run(m["startup"], scope=scope)
    tfluid.set_flags({"FLAGS_auto_recompute": True})
    counts = []
    gc.collect()
    gc.disable()
    try:
        for _ in range(3):
            exe.run(m["main"], feed=feed, fetch_list=[m["loss"]],
                    scope=scope)
            with warnings.catch_warnings():
                # the scan touches deprecated torch.distributed objects
                warnings.simplefilter("ignore", FutureWarning)
                counts.append(sum(isinstance(o, torch.Tensor)
                                  for o in gc.get_objects()))
    finally:
        gc.enable()
    assert _segments(_ran(exe, m["main"])) > 0
    assert counts[1] == counts[2], counts
