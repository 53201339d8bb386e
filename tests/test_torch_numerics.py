"""The PyTorch port's numerics analysis (``analysis/numerics.py``, the
PT900 family) against the JAX package's, on the CPU.

Each program is built in both packages by one shared build function under
``unique_name.guard()``. Compared: the diagnostics by (code, severity,
block, op index, op type) and message, every derived interval (to 1e-6
relative, 1e-12 absolute: both packages compute the bounds in Python
floats by the same rules, so they agree to rounding), ``static_intervals``
and the PT906 work-list. The positive and negative controls mirror the
JAX package's ``tests/test_numerics.py`` (its fixtures under
``tests/fixtures/numerics`` rebuilt here in both packages); the PT900/PT901
programs carry the fake-quant ops each package registers
(``ops/quant_ops.py``). Then the runtime side: with ``FLAGS_numerics_witness``
every value the port observes lies inside its static interval,
tolerance-free (``test_numwitness.py``'s containment check).
"""
import math
import types

import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu.unique_name as jun
from paddle_tpu.analysis import numerics as jnum
from paddle_tpu.monitor import numwitness as jnw

import paddle_tpu_torch as tfluid
import paddle_tpu_torch.unique_name as tun
from paddle_tpu_torch.analysis import (ALL_ANALYSIS_PASSES,
                                       default_pass_manager)
from paddle_tpu_torch.analysis import numerics as tnum
from paddle_tpu_torch.analysis.numerics import (TOP, Interval,
                                                NumericsReport,
                                                analyze_numerics,
                                                static_intervals)
from paddle_tpu_torch.monitor import numwitness as tnw

JAX = types.SimpleNamespace(name="jax", fl=jfluid, un=jun, num=jnum)
PORT = types.SimpleNamespace(name="port", fl=tfluid, un=tun, num=tnum)
IV_RTOL, IV_ATOL = 1e-6, 1e-12


def _build(P, fn):
    with P.un.guard():
        main, startup = P.fl.Program(), P.fl.Program()
        with P.fl.program_guard(main, startup):
            fetch, handles = fn(P, main)
    return main, startup, fetch, handles


def _key(d):
    return (d.code, d.severity, d.block_idx, d.op_idx, d.op_type)


def _assert_iv_close(t, j, name):
    for a, b in zip(t, j):
        if math.isinf(b):
            assert a == b, (name, t, j)
        else:
            assert abs(a - b) <= IV_ATOL + IV_RTOL * abs(b), (name, t, j)


def _both(fn, calibration=None):
    """analyze_numerics on the program ``fn`` builds, in both packages;
    asserts equal diagnostics and intervals and returns the port's report
    and handles."""
    reps = {}
    for P in (JAX, PORT):
        main, _, fetch, h = _build(P, fn)
        reps[P.name] = (P.num.analyze_numerics(main, fetch_names=fetch,
                                               calibration=calibration),
                        main, fetch, h)
    (jr, jm, jf, _), (tr, tm, tf, th) = reps["jax"], reps["port"]
    assert sorted(map(_key, tr.diagnostics)) == \
        sorted(map(_key, jr.diagnostics))
    assert sorted((_key(d), d.message) for d in tr.diagnostics) == \
        sorted((_key(d), d.message) for d in jr.diagnostics)
    assert set(tr.intervals) == set(jr.intervals)
    for n, iv in jr.intervals.items():
        _assert_iv_close(tr.intervals[n].to_tuple(), iv.to_tuple(), n)
    assert tr.calibrated == jr.calibrated
    assert (tr.is_training, tr.loss_scaling_active) == \
        (jr.is_training, jr.loss_scaling_active)
    assert tr.quant_sites == jr.quant_sites
    ts, js = (static_intervals(tm, tf), jnum.static_intervals(jm, jf))
    assert set(ts) == set(js)
    for n in js:
        _assert_iv_close(ts[n], js[n], n)
    return tr, th


def _codes(rep):
    return {d.code for d in rep.diagnostics}


def _fake_quant(P, main, op_type, x, name, in_scale=None):
    """One fake-quant(-dequant) op on ``x``, the op each package
    registers."""
    blk = main.global_block
    q = blk.create_var(name=f"{name}.quantized", shape=x.shape,
                       dtype="float32")
    s = blk.create_var(name=f"{name}.quant_scale", shape=(1,),
                       dtype="float32")
    ins = {"X": [x.name]}
    if in_scale is not None:
        ins["InScale"] = [in_scale]
    outs = {"Out": [q.name], "OutScale": [s.name]}
    blk.append_op(op_type, inputs=ins, outputs=outs,
                  attrs={"bit_length": 8})
    return q, s


# ---------------------------------------------------------------------------
# Interval algebra and transfer rules
# ---------------------------------------------------------------------------

def test_interval_algebra():
    iv = Interval(-2.0, 3.0)
    assert iv.known and not iv.is_top
    assert iv.absmax == 3.0
    assert iv.contains_zero()
    assert iv.hull(Interval(-5.0, 1.0)) == Interval(-5.0, 3.0)
    assert iv.scaled(-1.0) == Interval(-3.0, 2.0)
    assert iv.shifted(1.0) == Interval(-1.0, 4.0)
    assert TOP.is_top and not TOP.known
    assert not Interval(0.0, math.inf).is_top  # one-sided is information
    assert tnum.DTYPE_FINITE_MAX == jnum.DTYPE_FINITE_MAX


def test_transfer_table_is_the_reference_table():
    """The whole transfer table is kept, rules for op types the port does
    not register yet included: the same op families, the same constants."""
    for name in ("QUANT_SITE_TYPES", "QUANT_CONSUMER_TYPES",
                 "FAKE_QUANT_TYPES", "LOW_PRECISION_DTYPES",
                 "_REDUCE_TYPES", "_REL_SLACK", "_ABS_SLACK", "_CAST_REL"):
        assert getattr(tnum, name) == getattr(jnum, name), name


def test_structural_activation_bounds_are_exact():
    """relu/tanh/clip model no float arithmetic — their bounds are exact
    (the rounding slack applies only to arithmetic rules)."""
    def fn(P, main):
        x = P.fl.layers.data("x", shape=[4], dtype="float32")
        t = P.fl.layers.tanh(x)
        r = P.fl.layers.relu(t)
        c = P.fl.layers.clip(r, min=0.2, max=0.8)
        return [], (t, r, c)

    rep, (t, r, c) = _both(fn)
    assert rep.intervals[t.name].to_tuple() == (-1.0, 1.0)
    assert rep.intervals[r.name].to_tuple() == (0.0, 1.0)
    assert rep.intervals[c.name].to_tuple() == (0.2, 0.8)


def test_fill_constant_interval_contains_the_float32_value():
    """python 1e-4 is not a float32: the runtime materializes
    np.float32(1e-4) and the derived interval must contain THAT value."""
    def fn(P, main):
        return [], P.fl.layers.fill_constant(shape=[1], dtype="float32",
                                             value=1e-4)

    rep, c = _both(fn)
    lo, hi = rep.intervals[c.name].to_tuple()
    stored = float(np.float32(1e-4))
    assert lo <= stored <= hi and stored < 1e-4 and hi - lo < 1e-9


def test_gemm_growth_bounded_by_contraction_width():
    def fn(P, main):
        a = P.fl.layers.data("a", shape=[4, 8], dtype="float32")
        b = P.fl.layers.data("b", shape=[8, 5], dtype="float32")
        return [], P.fl.layers.matmul(P.fl.layers.tanh(a),
                                      P.fl.layers.tanh(b))

    rep, out = _both(fn)
    iv = rep.intervals[out.name]
    assert iv.known and 8.0 <= iv.absmax <= 8.0 * (1.0 + 1e-4)


def test_unknown_operand_stays_top_soundly():
    def fn(P, main):
        x = P.fl.layers.data("x", shape=[8], dtype="float32")
        return [], P.fl.layers.fc(x, 4)            # weight interval unknown

    rep, h = _both(fn)
    assert not rep.intervals.get(h.name, TOP).known


def test_elementwise_and_scale_chain():
    def fn(P, main):
        x = P.fl.layers.data("x", shape=[4], dtype="float32")
        s = P.fl.layers.sigmoid(x)                          # [0, 1]
        y = P.fl.layers.scale(s, scale=3.0, bias=-1.0)      # [-1, 2]
        return [], P.fl.layers.elementwise_add(y, s)        # [-1, 3]

    rep, z = _both(fn)
    lo, hi = rep.intervals[z.name].to_tuple()
    assert -1.001 < lo <= -1.0 and 3.0 <= hi < 3.001


# ---------------------------------------------------------------------------
# positive controls: each code trips (tests/fixtures/numerics, both packages)
# ---------------------------------------------------------------------------

def _pt900(P, main):
    x = P.fl.layers.data("x", shape=[4], dtype="float32")
    q, _ = _fake_quant(P, main, "fake_quantize_dequantize_abs_max", x, "x")
    out = P.fl.layers.relu(q)                  # off-path consumer -> PT900
    # dead fake-quant: output never consumed, never fetched -> PT900
    _fake_quant(P, main, "fake_quantize_dequantize_abs_max", x, "x_dead")
    return [out.name], None


def _pt901(P, main):
    """A training program whose moving-average scale is not persistable
    and not updated in place."""
    x = P.fl.layers.data("x", shape=[4], dtype="float32")
    y = P.fl.layers.data("y", shape=[1], dtype="float32")
    q, _ = _fake_quant(P, main,
                       "fake_quantize_dequantize_moving_average_abs_max", x,
                       "x", in_scale="x.scale_in")
    main.global_block.create_var(name="x.scale_in", shape=(1,),
                                 dtype="float32", persistable=True)
    h = P.fl.layers.fc(q, 8, act="relu")
    p = P.fl.layers.fc(h, 1)
    loss = P.fl.layers.mean(P.fl.layers.square(
        P.fl.layers.elementwise_sub(p, y)))
    P.fl.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return [loss.name], None


def _pt902(P, main):
    c = P.fl.layers.fill_constant(shape=[4], dtype="float32", value=1.0e6)
    h = P.fl.layers.cast(c, "float16")         # 1e6 > 65504 -> PT902
    return [P.fl.layers.cast(h, "float32").name], None


def _pt903(P, main):
    x = P.fl.layers.data("x", shape=[1024], dtype="float32")
    h = P.fl.layers.cast(x, "float16")
    s = P.fl.layers.reduce_sum(h)              # fp16 -> fp16 accumulate
    return [P.fl.layers.cast(s, "float32").name], None


def _mlp_loss(P):
    x = P.fl.layers.data("x", shape=[4], dtype="float32")
    y = P.fl.layers.data("y", shape=[1], dtype="float32")
    p = P.fl.layers.fc(P.fl.layers.fc(x, 8, act="relu"), 1)
    loss = P.fl.layers.mean(P.fl.layers.square(
        P.fl.layers.elementwise_sub(p, y)))
    P.fl.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return loss


def _unscale(P, main, grads):
    blk = main.global_block
    scale = P.fl.layers.fill_constant(shape=[1], dtype="float32",
                                      value=128.0)
    found = blk.create_var(name="found_inf", shape=(1,), dtype="bool")
    blk.append_op("check_finite_and_unscale",
                  inputs={"X": grads, "Scale": [scale.name]},
                  outputs={"Out": grads, "FoundInfinite": [found.name]})


def _pt904(P, main):
    loss = _mlp_loss(P)
    grads = sorted(n for n in main.global_block.vars
                   if n.endswith("@GRAD") and ".w_" in n)
    # unscale covers only the first weight grad -> PT904 per other grad
    _unscale(P, main, grads[:1])
    return [loss.name], None


def _pt905(P, main):
    c = P.fl.layers.fill_constant(shape=[4], dtype="float32", value=-1.0)
    bad_log = P.fl.layers.log(c)               # log of [-1, -1] -> PT905
    x = P.fl.layers.data("x", shape=[4], dtype="float32")
    den = P.fl.layers.tanh(x)                  # [-1, 1] contains 0
    q = P.fl.layers.elementwise_div(x, den)    # PT905
    return [P.fl.layers.mean(P.fl.layers.elementwise_add(q, bad_log)).name], \
        None


@pytest.mark.parametrize("build,code", [
    (_pt900, "PT900"), (_pt901, "PT901"), (_pt902, "PT902"),
    (_pt903, "PT903"), (_pt904, "PT904"), (_pt905, "PT905")])
def test_fixture_trips_expected_code(build, code):
    rep, _ = _both(build)
    assert code in _codes(rep), _codes(rep)


# ---------------------------------------------------------------------------
# negative controls: a guard clears each finding
# ---------------------------------------------------------------------------

def test_pt905_cleared_by_clip_guard():
    def fn(P, main):
        x = P.fl.layers.data("x", shape=[4], dtype="float32")
        safe = P.fl.layers.clip(x, min=0.1, max=10.0)
        lg = P.fl.layers.log(safe)
        den = P.fl.layers.clip(P.fl.layers.tanh(x), min=0.5, max=1.0)
        P.fl.layers.elementwise_div(x, den)
        return [], lg

    rep, lg = _both(fn)
    assert "PT905" not in _codes(rep)
    lo, hi = rep.intervals[lg.name].to_tuple()
    assert lo <= math.log(0.1) and hi >= math.log(10.0)


def test_pt902_cleared_by_clip_before_cast():
    def fn(P, main):
        c = P.fl.layers.fill_constant(shape=[4], dtype="float32",
                                      value=1e6)
        P.fl.layers.cast(P.fl.layers.clip(c, min=-100.0, max=100.0),
                         "float16")
        return [], None

    rep, _ = _both(fn)
    assert "PT902" not in _codes(rep)


def test_pt903_cleared_by_float32_accumulation():
    def fn(P, main):
        x = P.fl.layers.data("x", shape=[1024], dtype="float32")
        h = P.fl.layers.cast(x, "float16")
        P.fl.layers.reduce_sum(P.fl.layers.cast(h, "float32"))
        return [], None

    rep, _ = _both(fn)
    assert "PT903" not in _codes(rep)


def test_pt904_cleared_by_full_unscale_coverage():
    def fn(P, main):
        loss = _mlp_loss(P)
        _unscale(P, main, sorted(n for n in main.global_block.vars
                                 if n.endswith("@GRAD")
                                 and (".w_" in n or ".b_" in n)))
        return [loss.name], None

    rep, _ = _both(fn)
    assert rep.loss_scaling_active and "PT904" not in _codes(rep)


def test_pt900_pt901_clean_when_the_contract_holds():
    """A fake-quant feeding its GEMM, a persistable moving-average scale
    updated in place: no PT900/PT901."""
    def fn(P, main):
        x = P.fl.layers.data("x", shape=[4], dtype="float32")
        y = P.fl.layers.data("y", shape=[1], dtype="float32")
        q, s = _fake_quant(P, main,
                           "fake_quantize_dequantize_moving_average_abs_max",
                           x, "x", in_scale="x.quant_scale")
        s.persistable = True
        p = P.fl.layers.fc(q, 1)
        loss = P.fl.layers.mean(P.fl.layers.square(
            P.fl.layers.elementwise_sub(p, y)))
        P.fl.optimizer.SGD(learning_rate=0.1).minimize(loss)
        return [loss.name], None

    rep, _ = _both(fn)
    assert rep.is_training
    assert not {"PT900", "PT901"} & _codes(rep)


# ---------------------------------------------------------------------------
# PT906: the quantizability work-list
# ---------------------------------------------------------------------------

def _forward_mlp(act="relu", width=32):
    def fn(P, main):
        x = P.fl.layers.data("x", shape=[width], dtype="float32")
        h = P.fl.layers.fc(x, width, act=act)
        pred = P.fl.layers.fc(h, width)
        return [pred.name], pred
    return fn


def test_pt906_one_site_per_forward_gemm():
    rep, _ = _both(_forward_mlp())
    assert len(rep.quant_sites) == 2
    for site in rep.quant_sites:
        assert site["contraction_width"] == 32
        assert site["quant_annotated"] is False
    pt906 = [d for d in rep.diagnostics if d.code == "PT906"]
    assert len(pt906) == 2 and all(d.severity == "info" for d in pt906)


def test_pt906_is_a_superset_of_fusable_chain_bases():
    """Every GEMM the port's epilogue fusion claims as a chain base is in
    the PT906 work-list."""
    from paddle_tpu_torch.analysis.epilogue_fusion import (
        find_fusable_chains, fuse_epilogues)
    from paddle_tpu_torch.analysis.liveness import block_liveness

    for act in ("relu", "gelu"):
        main, _, fetch, _ = _build(PORT, _forward_mlp(act, 128))
        rep = analyze_numerics(main, fetch_names=fetch)
        sites = {s["op_idx"] for s in rep.quant_sites if s["block"] == 0}
        assert fuse_epilogues(main, fetch_names=fetch).n_fused == 2
        gb = main.global_block
        feeds = sorted(v.name for v in gb.vars.values() if v.is_data)
        chains = find_fusable_chains(main, block_liveness(gb, feeds, fetch),
                                     fetch)
        assert chains and all(c.op_indices[0] in sites for c in chains)


def test_calibration_is_tracked_separately_from_proofs():
    def fn(P, main):
        x = P.fl.layers.data("x", shape=[4], dtype="float32")
        return [], P.fl.layers.scale(x, scale=2.0)

    rep, y = _both(fn, calibration={"x": 3.0})
    assert rep.intervals["x"].to_tuple() == (-3.0, 3.0)
    assert rep.intervals[y.name].known
    assert {"x", y.name} <= rep.calibrated
    assert "x" not in rep.bounded_intervals(proven_only=True)
    assert y.name not in rep.bounded_intervals(proven_only=True)
    main, _, _, _ = _build(PORT, fn)
    assert "x" not in static_intervals(main)


# ---------------------------------------------------------------------------
# the model programs, pass registration
# ---------------------------------------------------------------------------

def _bert(P, main):
    from paddle_tpu.models import bert as jb
    from paddle_tpu_torch.models import bert as tb

    m = jb if P is JAX else tb
    net = m.build_bert_pretrain(m.BertConfig.tiny(), 32, amp=True)
    return [net["loss"].name], net


def _resnet(P, main):
    from paddle_tpu.models import resnet as jr
    from paddle_tpu_torch.models import resnet as tr

    net = (jr if P is JAX else tr).build_resnet(
        18, class_num=10, image_shape=(3, 64, 64), amp=True)
    return [net["loss"].name], net


@pytest.mark.parametrize("build_fn", [_bert, _resnet])
def test_model_programs_agree(build_fn):
    """BERT-tiny and ResNet-18 bf16 training (built, not run): equal
    diagnostics, intervals, static intervals and PT906 work-lists."""
    reps = {}
    for P in (JAX, PORT):
        with P.un.guard():
            fetch, net = build_fn(P, None)
        for tag, prog in (("train", net["main"]),
                          ("test", net["main"].clone(for_test=True))):
            reps.setdefault(tag, {})[P.name] = (prog, fetch)
    for tag, by in reps.items():
        (jm, jf), (tm, tf) = by["jax"], by["port"]
        jr = jnum.analyze_numerics(jm, fetch_names=jf)
        tr = tnum.analyze_numerics(tm, fetch_names=tf)
        assert sorted(map(_key, tr.diagnostics)) == \
            sorted(map(_key, jr.diagnostics)), tag
        assert tr.quant_sites == jr.quant_sites, tag
        ts, js = static_intervals(tm, tf), jnum.static_intervals(jm, jf)
        assert set(ts) == set(js), tag
        for n in js:
            _assert_iv_close(ts[n], js[n], n)


def test_numerics_check_is_a_registered_analysis_pass():
    assert "numerics_check" in ALL_ANALYSIS_PASSES
    main, _, fetch, _ = _build(PORT, _pt905)
    result = default_pass_manager().run_pipeline(
        main, ("numerics_check",), fetch_names=list(fetch), verify="none")
    assert "PT905" in {d.code for d in result.diagnostics}
    rep = result.values["numerics_check"]
    assert isinstance(rep, NumericsReport)
    assert result.context.analysis("numerics_check") is rep


def test_numerics_check_reads_calibration_option():
    def fn(P, main):
        x = P.fl.layers.data("x", shape=[4], dtype="float32")
        P.fl.layers.scale(x, scale=2.0)
        return [], None

    main, _, _, _ = _build(PORT, fn)
    result = default_pass_manager().run_pipeline(
        main, ("numerics_check",),
        options={"numerics_calibration": {"x": 7.0}}, verify="none")
    rep = result.values["numerics_check"]
    assert rep.intervals["x"].to_tuple() == (-7.0, 7.0)
    assert "x" in rep.calibrated


# ---------------------------------------------------------------------------
# runtime containment (the witness against the static side)
# ---------------------------------------------------------------------------

@pytest.fixture
def witness_on():
    prev = tfluid.get_flags(["FLAGS_numerics_witness"])
    tnw.reset_numerics_witness()
    tfluid.set_flags({"FLAGS_numerics_witness": 1})
    yield
    tfluid.set_flags(prev)
    tnw.reset_numerics_witness()


def _bounded(P, main):
    x = P.fl.layers.data("x", shape=[8], dtype="float32")
    t = P.fl.layers.tanh(x)
    s = P.fl.layers.sigmoid(t)
    out = P.fl.layers.mean(P.fl.layers.scale(s, scale=2.0))
    return [out.name], out


@pytest.mark.parametrize("build_fn", [_bounded, _bert])
def test_witness_observes_vars_and_contains_them(witness_on, build_fn):
    """The port's witness, tolerance-free, inside the port's static
    intervals: a bounded chain (tanh/sigmoid/scale/mean, 2 steps) and a
    BERT-tiny bf16 training step, fed random data."""
    if build_fn is _bert:          # builds its own programs
        with tun.guard():
            fetch, net = _bert(PORT, None)
        main, startup = net["main"], net["startup"]
    else:
        main, startup, fetch, _ = _build(PORT, build_fn)
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    exe.run(startup, scope=scope)
    rng = np.random.RandomState(0)
    if build_fn is _bounded:
        feeds = [{"x": rng.randn(4, 8).astype(np.float32)} for _ in range(2)]
    else:
        B, S = 2, 32
        m = rng.rand(B, S) < 0.15
        feeds = [{"src_ids": rng.randint(0, 1024, (B, S)).astype(np.int64),
                  "pos_ids": np.tile(np.arange(S), (B, 1)).astype(np.int64),
                  "sent_ids": np.zeros((B, S), np.int64),
                  "input_mask": np.ones((B, S), np.float32),
                  "mask_label": np.where(m, rng.randint(0, 1024, (B, S)),
                                         -100).astype(np.int64),
                  "next_sent_label": rng.randint(0, 2, (B, 1))
                  .astype(np.int64)}]
    for f in feeds:
        exe.run(main, feed=f, fetch_list=fetch, scope=scope)
    observed = tnw.numerics_witness_vars()
    static = static_intervals(main, fetch_names=fetch)
    assert set(static) & set(observed), \
        "bounded vars (tanh/sigmoid/...) must be witnessed"
    assert tnw.containment_violations(static, observed) == []
    # the same check through the JAX package's function gives the same
    assert jnw.containment_violations(static, observed) == []
