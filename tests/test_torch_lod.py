"""LoD inputs in the port against the JAX package, on the CPU, at a tiny
size: ``layers.data(lod_level=1)`` and its ``@LOD`` companion, the
``DataFeeder``, ``seq_len_var``'s producer walk, the sequence, recurrent
and structured layers, ``DynamicRNN`` and
``models.seq2seq.build_seq2seq_train_varlen``.

* ``to_dict()`` of every program is the JAX package's (int32 read as
  int64, source paths dropped), companions and ``assign`` ops included;
* the layer programs' fetches agree (f32 rtol 1e-5, atol 1e-6);
* three whole paths train from the JAX package's initial scope
  (``interop.scope_from_numpy``, no transform of any weight) to its
  losses: rtol 1e-5 at step 1, 1e-4 after (Adam moves the two packages'
  f32 rounding apart): the varlen seq2seq, the book's GRU
  encoder-decoder and the book's bi-LSTM + CRF tagger;
* the registry is the JAX package's minus the op types still to port.
"""
import json
import warnings

import numpy as np
import pytest

import paddle_tpu as fluid
import paddle_tpu.unique_name as jun
from paddle_tpu.models import seq2seq as jseq

import paddle_tpu_torch as tfluid
import paddle_tpu_torch.unique_name as tun
from paddle_tpu_torch.interop import scope_from_numpy
from paddle_tpu_torch.models import seq2seq as tseq

PKGS = {"jax": (fluid, jun), "torch": (tfluid, tun)}
LOSS_RTOL = (1e-5, 1e-4)
RTOL, ATOL = 1e-5, 1e-6


def normalized(prog):
    """to_dict() without source paths, int32 read as int64 (in var dtypes
    and in a cast's dtype attrs: the JAX package runs with 64-bit types
    off, so its int64 results are int32)."""
    d = prog.to_dict()
    for b in d["blocks"]:
        for v in b["vars"]:
            if v["dtype"] == "int32":
                v["dtype"] = "int64"
        for o in b["ops"]:
            o["attrs"].pop("op_callstack", None)
            for k in ("in_dtype", "out_dtype"):
                if o["attrs"].get(k) == "int32":
                    o["attrs"][k] = "int64"
    return json.loads(json.dumps(d))


def build_both(fn):
    """``fn(fluid)`` under a fresh name guard and program pair in each
    package: {pkg: (main, startup, fn's result)}."""
    out = {}
    for pkg, (fl, un) in PKGS.items():
        with un.guard():
            main, startup = fl.Program(), fl.Program()
            with fl.program_guard(main, startup):
                res = fn(fl)
        out[pkg] = (main, startup, res)
    return out


def carried_scopes(built, seed=3):
    """The JAX package's startup run once; its values planted in a port
    scope as they are. Returns the executors and scopes."""
    jmain, jstart, _ = built["jax"]
    tmain = built["torch"][0]
    jstart.random_seed = seed
    jexe, jscope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    jexe.run(jstart, scope=jscope)
    state = {n: jscope.numpy(n) for n in jstart.global_block.vars}
    texe, tscope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    scope_from_numpy(state, tscope, tfluid.CPUPlace(), programs=[tmain])
    return {"jax": (jexe, jscope), "torch": (texe, tscope)}, state


def run_steps(built, feeds, fetch, seed=3):
    scopes, _ = carried_scopes(built, seed)
    res = {}
    for pkg in PKGS:
        exe, scope = scopes[pkg]
        res[pkg] = [[np.asarray(v) for v in exe.run(
            built[pkg][0], feed=feed, fetch_list=fetch, scope=scope)]
            for feed in feeds]
    return res


# -------------------------------------------------------------- data/feed
def test_lod_data_declares_the_padded_var_and_its_companion():
    def fn(fl):
        fl.layers.data("w", shape=[1], dtype="int64", lod_level=1)
        fl.layers.data("f", shape=[5], dtype="float32", lod_level=1)
        fl.layers.data("g", shape=[-1, -1, 3], dtype="float32", lod_level=1)
        fl.layers.data("d", shape=[4], dtype="float32")
    b = build_both(fn)
    assert normalized(b["torch"][0]) == normalized(b["jax"][0])
    blk = b["torch"][0].global_block
    assert blk.var("w").shape == (-1, -1, 1) and blk.var("w").lod_level == 1
    lod = blk.var("w@LOD")
    assert (lod.shape, lod.dtype, lod.stop_gradient, lod.is_data) == \
        ((-1,), "int32", True, True)
    assert not blk.has_var("d@LOD")


def _feeder_samples(rng, n, lo, hi):
    out = []
    for _ in range(n):
        L = int(rng.randint(lo, hi + 1))
        out.append((rng.randint(0, 9, L).astype(np.int64),
                    rng.randn(L, 3).astype(np.float32),
                    np.float32(rng.randn()), rng.randint(0, 5)))
    return out


@pytest.mark.parametrize("buckets,lo,hi", [((8, 16), 1, 7), ((8, 16), 9, 16),
                                           ((4,), 3, 11), ((8,), 0, 0)])
def test_data_feeder_pads_and_buckets_as_jax(buckets, lo, hi):
    """Padded lengths follow ``bucket_length`` (doubling past the largest
    bucket: 11 with buckets (4,) pads to 16), token scalars get their
    trailing 1, dtypes are coerced, and every array equals the JAX
    feeder's."""
    from paddle_tpu.data_feeder import bucket_length as jbucket
    from paddle_tpu_torch.data_feeder import bucket_length

    def fn(fl):
        return [fl.layers.data("ids", shape=[1], dtype="int64", lod_level=1),
                fl.layers.data("vec", shape=[3], dtype="float32",
                               lod_level=1),
                fl.layers.data("x", shape=[1], dtype="float32"),
                fl.layers.data("y", shape=[1], dtype="int64")]
    b = build_both(fn)
    samples = _feeder_samples(np.random.RandomState(lo + hi), 5, lo, hi)
    fed = {}
    for pkg, (fl, _) in PKGS.items():
        main, _, vars_ = b[pkg]
        fed[pkg] = fl.DataFeeder(feed_list=vars_, program=main,
                                 seq_buckets=buckets).feed(samples)
    assert sorted(fed["torch"]) == sorted(fed["jax"]) == \
        ["ids", "ids@LOD", "vec", "vec@LOD", "x", "y"]
    for k, v in fed["torch"].items():
        assert v.dtype == fed["jax"][k].dtype, k
        np.testing.assert_array_equal(v, fed["jax"][k], err_msg=k)
    longest = max(len(s[0]) for s in samples)
    assert fed["torch"]["ids"].shape == \
        (5, bucket_length(longest, buckets), 1)
    for n in (0, 1, 4, 5, 16, 17, 100):
        assert bucket_length(n, buckets) == jbucket(n, buckets)
    assert bucket_length(11, (4,)) == 16 and bucket_length(3, ()) == 4


def test_data_feeder_by_names_and_its_errors():
    def fn(fl):
        fl.layers.data("ids", shape=[1], dtype="int64", lod_level=1)
    main = build_both(fn)["torch"][0]
    feeder = tfluid.DataFeeder(["ids"], program=main)
    out = feeder.feed([np.arange(3), np.arange(5)])
    assert out["ids"].shape == (2, 8, 1)
    np.testing.assert_array_equal(out["ids@LOD"], [3, 5])
    with pytest.raises(ValueError, match="empty minibatch"):
        feeder.feed([])
    with pytest.raises(ValueError, match="need a program"):
        tfluid.DataFeeder(["ids"])
    with pytest.raises(ValueError, match="feed_list expects"):
        feeder.feed([(np.arange(2), np.arange(2))])


# --------------------------------------------------------------- seq_len_var
def test_seq_len_var_walk_error_and_warning_match_jax():
    def fn(fl):
        a = fl.layers.data("a", shape=[4], dtype="float32", lod_level=1)
        c = fl.layers.data("c", shape=[4], dtype="float32", lod_level=1)
        plain = fl.layers.data("p", shape=[-1, 6, 4], dtype="float32")
        walked = fl.layers.sequence.seq_len_var(fl.layers.relu(
            fl.layers.scale(a, 2.0)))
        mixed = fl.layers.elementwise_add(fl.layers.relu(a), c)
        return walked, mixed, plain
    b = build_both(fn)
    msgs = {}
    for pkg, (fl, un) in PKGS.items():
        main, startup, (walked, mixed, plain) = b[pkg]
        assert walked.name == "a@LOD"
        with fl.program_guard(main, startup):
            with warnings.catch_warnings(record=True) as w:
                warnings.simplefilter("always")
                got = fl.layers.sequence.seq_len_var(mixed)
            assert got.name == "a@LOD"
            with pytest.raises(ValueError) as e:
                fl.layers.sequence.seq_len_var(plain)
        msgs[pkg] = ([str(x.message) for x in w
                      if x.category is RuntimeWarning], str(e.value))
    assert msgs["torch"] == msgs["jax"]
    assert len(msgs["torch"][0]) == 1 and "a@LOD" in msgs["torch"][0][0] \
        and "c@LOD" in msgs["torch"][0][0]
    assert "declare the input with layers.data" in msgs["torch"][1]


# ---------------------------------------------------------- layer programs
B, T, D, H = 4, 8, 3, 8
LENS = np.array([0, 1, 8, 5], np.int32)


def _seq_layers(fl):
    L = fl.layers
    x = L.data("x", shape=[D], dtype="float32", lod_level=1)
    y = L.data("y", shape=[2], dtype="float32", lod_level=1)
    ids = L.data("ids", shape=[], dtype="int64", lod_level=1)
    row = L.data("row", shape=[D], dtype="float32")
    wide = L.data("wide", shape=[10], dtype="float32")
    x.stop_gradient = False
    outs = [L.sequence_pool(x, p) for p in
            ("sum", "average", "sqrt", "max", "min", "last", "first")]
    outs += [L.sequence_first_step(x), L.sequence_last_step(x),
             L.sequence_softmax(L.reduce_sum(x, dim=2)),
             L.sequence_reverse(x), L.sequence_expand(row, y),
             L.sequence_concat([x, L.sequence_reverse(x)]),
             L.sequence_pad(x, L.assign(np.float32([0.5])), maxlen=10)[0],
             L.sequence_conv(x, 4, filter_size=3, act="tanh"),
             L.sequence_mask(L.sequence.seq_len_var(x), maxlen=T),
             L.sequence_reshape(L.sequence_concat([x, x]), new_dim=2),
             L.sequence_expand_as(row, y),
             L.sequence_scatter(wide, ids, L.cast(ids, "float32")),
             L.sequence_erase(ids, [2, 3]),
             L.sequence_enumerate(ids, 2, pad_value=9)]
    padded, length = L.sequence_pad(x, L.assign(np.float32([0.0])))
    outs += [L.sequence_unpad(padded, length), length,
             L.sequence_slice(x, L.assign(np.array([[0], [0], [2], [1]],
                                                   np.int64)),
                              L.assign(np.array([[0], [1], [3], [2]],
                                                np.int64))),
             L.lod_reset(x, y=y), L.lod_reset(x, target_lod=[0, 1, 3, 6, 8])]
    loss = L.mean(outs[0]) + L.mean(outs[-5])
    grads = fl.gradients([loss], [x])
    return outs + grads


def _rnn_layers(fl):
    L = fl.layers
    x = L.data("x", shape=[D], dtype="float32", lod_level=1)
    x.stop_gradient = False
    g4 = L.fc(x, 4 * H, num_flatten_dims=2)
    fwd, cell = L.dynamic_lstm(g4, 4 * H)
    rev, _ = L.dynamic_lstm(g4, 4 * H, use_peepholes=False, is_reverse=True)
    proj, pcell = L.dynamic_lstmp(g4, 4 * H, proj_size=3)
    g3 = L.fc(x, 3 * H, num_flatten_dims=2)
    gru = L.dynamic_gru(g3, H, h_0=L.sequence_pool(fwd, "last"))
    gru_o = L.dynamic_gru(g3, H, is_reverse=True, origin_mode=True)
    unit, reset_h, gate = L.gru_unit(L.sequence_first_step(g3),
                                     L.sequence_last_step(gru), 3 * H)
    out, last_h, last_c = L.lstm(x, None, None, T, H, num_layers=2)
    logits = L.fc(x, 4, num_flatten_dims=2)
    label = L.data("label", shape=[], dtype="int64", lod_level=1)
    ctc = L.warpctc(logits, label, blank=0, norm_by_times=True)
    loss = L.mean(gru) + L.mean(gru_o) + L.mean(unit) + L.mean(out) \
        + L.mean(ctc) + L.mean(rev) + L.mean(proj)
    grads = fl.gradients([loss], [x])
    return [fwd, cell, rev, proj, pcell, gru, gru_o, unit, reset_h, gate,
            out, last_h, last_c, ctc] + grads


def _structured_layers(fl):
    L = fl.layers
    x = L.data("x", shape=[D], dtype="float32", lod_level=1)
    x.stop_gradient = False
    tags = L.data("tags", shape=[1], dtype="int64", lod_level=1)
    em = L.fc(x, 5, num_flatten_dims=2)
    cost = L.linear_chain_crf(em, tags, param_attr=fl.ParamAttr(name="crfw"))
    path = L.crf_decoding(em, param_attr=fl.ParamAttr(name="crfw"))
    right = L.crf_decoding(em, param_attr=fl.ParamAttr(name="crfw"),
                           label=tags)
    chunks = L.chunk_eval(path, tags, chunk_scheme="IOB", num_chunk_types=2)
    row = L.sequence_last_step(x)
    lbl = L.data("lbl", shape=[1], dtype="int64")
    hs = L.hsigmoid(row, lbl, num_classes=6)
    decoded, dec_len = L.ctc_greedy_decoder(L.softmax(em), blank=0)
    dist, n = L.edit_distance(decoded, tags, normalized=False)
    loss = L.mean(cost) + L.mean(hs)
    grads = fl.gradients([loss], [x])
    return [cost, path, right, *chunks, hs, decoded, dec_len, dist, n] + grads


def _layer_feed(rng):
    ids = rng.randint(0, 6, (B, T)).astype(np.int64)
    return {"x": rng.randn(B, T, D).astype(np.float32), "x@LOD": LENS,
            "y": rng.randn(B, T, 2).astype(np.float32), "y@LOD": LENS[::-1]
            .copy(), "ids": ids, "ids@LOD": LENS,
            "row": rng.randn(B, D).astype(np.float32),
            "wide": rng.randn(B, 10).astype(np.float32),
            "label": rng.randint(1, 4, (B, 3)).astype(np.int64),
            "label@LOD": np.array([3, 0, 2, 1], np.int32),
            "tags": rng.randint(0, 5, (B, T, 1)).astype(np.int64),
            "tags@LOD": LENS,
            "lbl": rng.randint(0, 6, (B, 1)).astype(np.int64)}


@pytest.mark.parametrize("build", [_seq_layers, _rnn_layers,
                                   _structured_layers],
                         ids=["sequence", "rnn", "structured"])
def test_layer_programs_match_jax(build):
    """Built alike (vars, ops, attrs, companions, ``assign`` ops) and run
    alike from the same weights: every output and the input gradient."""
    b = build_both(build)
    assert normalized(b["torch"][0]) == normalized(b["jax"][0])
    assert normalized(b["torch"][1]) == normalized(b["jax"][1])
    types = {o.type for o in b["torch"][0].global_block.ops}
    assert "assign" in types
    feed = _layer_feed(np.random.RandomState(1))
    fetch = [v.name for v in b["torch"][2]]
    feed = {k: v for k, v in feed.items()
            if b["torch"][0].global_block.has_var(k)}
    res = run_steps(b, [feed], fetch)
    for name, t, j in zip(fetch, res["torch"][0], res["jax"][0]):
        assert t.shape == j.shape, name
        if np.issubdtype(j.dtype, np.floating):
            np.testing.assert_allclose(t, j, rtol=RTOL, atol=ATOL,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(t.astype(np.int64),
                                          j.astype(np.int64), err_msg=name)


def test_weight_layouts_carry_across_unchanged():
    """The recurrent and CRF parameters have the JAX package's names,
    shapes and dtypes (GRU [H, 3H], LSTM [H, 4H] with a 7H peephole bias,
    cudnn_lstm's flat W, the CRF transition [tags+2, tags]); planted as
    they are, they give the JAX package's outputs (the layer program
    test)."""
    b = build_both(lambda fl: (_rnn_layers(fl), _structured_layers(fl)))
    shapes = {}
    for pkg in PKGS:
        shapes[pkg] = {p.name: (tuple(p.shape), p.dtype)
                       for p in b[pkg][0].all_parameters()}
    assert shapes["torch"] == shapes["jax"]
    got = sorted(shapes["torch"].values())
    for want in [((H, 3 * H), "float32"), ((1, 3 * H), "float32"),
                 ((H, 4 * H), "float32"), ((1, 7 * H), "float32"),
                 ((1, 4 * H), "float32"), ((7, 5), "float32"),
                 ((4 * H * D + 4 * H * H + 8 * H + 4 * H * H * 2 + 8 * H,),
                  "float32")]:
        assert want in got, want
    _, state = carried_scopes(b)
    assert state["crfw"].shape == (7, 5)


def test_dynamic_rnn_matches_jax():
    """DynamicRNN on the port's StaticRNN: the same program, and from the
    same weights the same masked outputs, last steps and loss over three
    SGD steps."""
    def fn(fl):
        L = fl.layers
        ids = L.data("ids", shape=[1], dtype="int64", lod_level=1)
        emb = L.embedding(ids, size=[20, 6])
        drnn = L.DynamicRNN()
        with drnn.block():
            w = drnn.step_input(emb)
            prev = drnn.memory(shape=[H])
            h = L.fc(L.concat([w, prev], 1), H, act="tanh")
            drnn.update_memory(prev, h)
            drnn.output(h)
        hidden = drnn()
        last = L.sequence_last_step(hidden)
        loss = L.mean(L.fc(last, 1))
        fl.optimizer.SGD(0.1).minimize(loss)
        return hidden, last, loss
    b = build_both(fn)
    assert normalized(b["torch"][0]) == normalized(b["jax"][0])
    rng = np.random.RandomState(2)
    feed = {"ids": rng.randint(0, 20, (B, T, 1)).astype(np.int64),
            "ids@LOD": LENS}
    fetch = [v.name for v in b["torch"][2]]
    res = run_steps(b, [feed] * 3, fetch)
    for step in range(3):
        for t, j in zip(res["torch"][step], res["jax"][step]):
            np.testing.assert_allclose(t, j, rtol=LOSS_RTOL[step > 0],
                                       atol=ATOL)
    hidden = res["torch"][0][0]
    assert (hidden[np.arange(T)[None, :] >= LENS[:, None]] == 0).all()


# ----------------------------------------------------------- whole paths
VOCAB, EMB, HID = 30, 8, 16


def _varlen(fl):
    mod = jseq if fl is fluid else tseq
    return mod.build_seq2seq_train_varlen(VOCAB, VOCAB, EMB, HID, lr=1e-2)


def _varlen_samples(rng, n, lo, hi):
    out = []
    for _ in range(n):
        L = int(rng.randint(lo, hi + 1))
        s = rng.randint(2, VOCAB, L).astype(np.int64)
        out.append((s, np.concatenate([[0], s[:-1]]), s))
    return out


def _varlen_built():
    with warnings.catch_warnings():
        # the token loss's producers reach both companions (the JAX
        # package warns alike): the first, the target's, is the binding
        warnings.simplefilter("ignore", RuntimeWarning)
        out = {}
        for pkg, (fl, un) in PKGS.items():
            with un.guard():
                m = _varlen(fl)
            out[pkg] = (m["main"], m["startup"], m)
    return out


def test_varlen_seq2seq_program_matches_jax():
    b = _varlen_built()
    for i in (0, 1):
        assert normalized(b["torch"][i]) == normalized(b["jax"][i])
    ops = [o.type for o in b["torch"][0].global_block.ops]
    assert ops.count("sequence_pool") == 2 and "recurrent" in ops


def test_varlen_seq2seq_trains_as_jax():
    """Batches from the port's DataFeeder in two buckets (8 and 16),
    lengths 1..12: three Adam steps give the JAX package's losses; the
    padded shapes are the buckets' (the port compiles nothing, so the
    JAX test's executable count has no counterpart)."""
    b = _varlen_built()
    rng = np.random.RandomState(5)
    m = b["torch"][2]
    feeder = tfluid.DataFeeder(feed_list=m["feed_vars"], program=m["main"])
    feeds = [feeder.feed(_varlen_samples(rng, 6, 1, 8)),
             feeder.feed(_varlen_samples(rng, 6, 9, 12)),
             feeder.feed(_varlen_samples(rng, 6, 1, 8))]
    assert [f["src_ids"].shape for f in feeds] == \
        [(6, 8, 1), (6, 16, 1), (6, 8, 1)]
    res = run_steps(b, feeds, [m["loss"].name])
    losses = [float(r[0].reshape(-1)[0]) for r in res["torch"]]
    for step in range(3):
        np.testing.assert_allclose(res["torch"][step][0],
                                   res["jax"][step][0],
                                   rtol=LOSS_RTOL[step > 0])
    assert np.isfinite(losses).all()


def test_varlen_loss_ignores_padding():
    """One batch padded to 8 and to 32 gives the same loss (rtol 1e-5):
    padding contributes nothing."""
    b = _varlen_built()
    m = b["torch"][2]
    samples = _varlen_samples(np.random.RandomState(9), 6, 3, 7)
    scopes, _ = carried_scopes(b)
    exe, scope = scopes["torch"]
    state = {n: scope.vars[n].clone() for n in scope.vars}
    losses = []
    for buckets in ((8,), (32,)):
        feed = tfluid.DataFeeder(feed_list=m["feed_vars"], program=m["main"],
                                 seq_buckets=buckets).feed(samples)
        fresh = tfluid.Scope()
        for n, t in state.items():
            fresh.set_var(n, t.clone())
        losses.append(float(np.ravel(exe.run(
            m["main"], feed=feed, fetch_list=[m["loss"].name],
            scope=fresh)[0])[0]))
    np.testing.assert_allclose(losses[0], losses[1], rtol=1e-5)


def gru_encdec(fl, vocab=VOCAB, emb_dim=EMB, hid=HID, t_max=8, lr=5e-3):
    """The book's RNN encoder-decoder (``tests/test_book2.py``): a GRU
    encoder, its last valid state starting a GRU decoder, teacher-forced
    cross-entropy masked by the target lengths."""
    L = fl.layers
    src = L.data("src", shape=[1], dtype="int64", lod_level=1)
    trg = L.data("trg", shape=[1], dtype="int64", lod_level=1)
    trg_next = L.data("trg_next", shape=[1], dtype="int64", lod_level=1)
    s_emb = L.embedding(src, size=[vocab, emb_dim])
    s_gates = L.fc(s_emb, 3 * hid, num_flatten_dims=2)
    enc = L.dynamic_gru(s_gates, size=hid)
    enc_last = L.sequence_last_step(enc)
    t_emb = L.embedding(trg, size=[vocab, emb_dim])
    t_gates = L.fc(t_emb, 3 * hid, num_flatten_dims=2)
    dec = L.dynamic_gru(t_gates, size=hid, h_0=enc_last)
    logits = L.fc(dec, vocab, num_flatten_dims=2)
    ce = L.softmax_with_cross_entropy(logits, trg_next)
    mask = L.cast(L.sequence_mask(L.sequence.seq_len_var(trg),
                                  maxlen=t_max), "float32")
    loss = L.reduce_sum(L.squeeze(ce, axes=[2]) * mask) / (
        L.reduce_sum(mask) + 1e-6)
    fl.optimizer.Adam(learning_rate=lr).minimize(loss)
    return {"loss": loss, "feed_vars": [src, trg, trg_next], "enc": enc,
            "enc_last": enc_last}


def test_gru_encoder_decoder_trains_as_jax():
    """The book graph through both packages' DataFeeders (buckets (8,)),
    lengths 1..8 with a 0-length source row: three Adam steps give the
    JAX package's losses, the encoder's Hidden and last step at step 1
    too; Hidden is exactly 0 past each length and the last step is
    Hidden[b, len - 1]."""
    b = build_both(gru_encdec)
    assert normalized(b["torch"][0]) == normalized(b["jax"][0])
    rng = np.random.RandomState(4)
    feeds = []
    for step in range(3):
        samples = []
        for i in range(5):
            n = 0 if (i == 0 and step == 0) else int(rng.randint(1, 8))
            s = rng.randint(2, VOCAB, n).astype(np.int64)
            tgt = rng.randint(2, VOCAB, int(rng.randint(1, 8))) \
                .astype(np.int64)
            samples.append((s, np.concatenate([[0], tgt]),
                            np.concatenate([tgt, [1]])))
        feeds.append(samples)
    res = {}
    scopes, _ = carried_scopes(b)
    for pkg, (fl, _) in PKGS.items():
        main, _, net = b[pkg]
        feeder = fl.DataFeeder(feed_list=net["feed_vars"], program=main,
                               seq_buckets=(8,))
        exe, scope = scopes[pkg]
        res[pkg] = [[np.asarray(v) for v in exe.run(
            main, feed=feeder.feed(s), scope=scope,
            fetch_list=[net["loss"].name, net["enc"].name,
                        net["enc_last"].name])] for s in feeds]
    for step in range(3):
        np.testing.assert_allclose(res["torch"][step][0],
                                   res["jax"][step][0],
                                   rtol=LOSS_RTOL[step > 0])
    _, hid, last = res["torch"][0]
    np.testing.assert_allclose(hid, res["jax"][0][1], rtol=RTOL, atol=ATOL)
    lens = np.array([len(s[0]) for s in feeds[0]])
    assert (hid[np.arange(8)[None, :] >= lens[:, None]] == 0).all()
    want = hid[np.arange(5), np.maximum(lens - 1, 0)]
    np.testing.assert_array_equal(last, want)


def bilstm_crf(fl, words=40, labels=5, hid=8):
    """The book's label_semantic_roles gate (``tests/test_book2.py``):
    word + mark embeddings, a bi-LSTM, linear_chain_crf; decode with
    crf_decoding, score with chunk_eval."""
    L = fl.layers
    word = L.data("word", shape=[1], dtype="int64", lod_level=1)
    mark = L.data("mark", shape=[1], dtype="int64", lod_level=1)
    target = L.data("target", shape=[1], dtype="int64", lod_level=1)
    feat = L.concat([L.embedding(word, size=[words, 8]),
                     L.embedding(mark, size=[2, 4])], axis=2)
    fwd, _ = L.dynamic_lstm(L.fc(feat, 4 * hid, num_flatten_dims=2),
                            size=4 * hid)
    rev, _ = L.dynamic_lstm(L.fc(feat, 4 * hid, num_flatten_dims=2),
                            size=4 * hid, is_reverse=True)
    emission = L.fc(L.concat([fwd, rev], axis=2), labels,
                    num_flatten_dims=2)
    length = L.sequence.seq_len_var(word)
    cost = L.linear_chain_crf(input=emission, label=target,
                              param_attr=fl.ParamAttr(name="crfw"),
                              length=length)
    loss = L.mean(cost)
    fl.optimizer.Adam(learning_rate=0.02).minimize(loss)
    decode = L.crf_decoding(input=emission,
                            param_attr=fl.ParamAttr(name="crfw"),
                            length=length)
    f1 = L.chunk_eval(decode, target, chunk_scheme="IOB",
                      num_chunk_types=(labels - 1) // 2,
                      seq_length=length)[2]
    return {"loss": loss, "decode": decode, "f1": f1,
            "feed_vars": [word, mark, target]}


def test_bilstm_crf_trains_as_jax():
    b = build_both(bilstm_crf)
    assert normalized(b["torch"][0]) == normalized(b["jax"][0])
    rng = np.random.RandomState(6)
    net = b["torch"][2]
    feeder = tfluid.DataFeeder(feed_list=net["feed_vars"],
                               program=b["torch"][0], seq_buckets=(8,))
    feeds = []
    for _ in range(3):
        samples = []
        for i in range(6):
            n = 1 if i == 0 else int(rng.randint(2, 9))
            samples.append((rng.randint(0, 40, n)[:, None],
                            rng.randint(0, 2, n)[:, None],
                            rng.randint(0, 5, n)[:, None]))
        feeds.append(feeder.feed(samples))
    res = run_steps(b, feeds, [net["loss"].name, net["decode"].name,
                               net["f1"].name])
    for step in range(3):
        t, j = res["torch"][step], res["jax"][step]
        np.testing.assert_allclose(t[0], j[0], rtol=LOSS_RTOL[step > 0])
        np.testing.assert_array_equal(t[1], j[1].astype(np.int64))
        np.testing.assert_allclose(t[2], j[2], rtol=1e-5)


# ------------------------------------------------------------- registry
# op types of the JAX package the port does not register yet
STILL_TO_PORT = set()


def builtin_ops(registry, package):
    """The op types of ``registry`` whose rule lives in ``package``. A
    type a test registers in the process-wide registry (and other test
    files on the same worker may leave behind) is not one of them."""
    return {t for t in registry.all_ops()
            if getattr(registry.get_op_def(t).lower, "__module__",
                       "").startswith(package + ".")}


def assert_registry_parity():
    from paddle_tpu.core import registry as jreg
    from paddle_tpu_torch.core import registry as treg

    jax_ops = builtin_ops(jreg, "paddle_tpu")
    port_ops = builtin_ops(treg, "paddle_tpu_torch")
    assert len(STILL_TO_PORT) == 0
    assert port_ops == jax_ops - STILL_TO_PORT
    assert len(port_ops) == 297 and len(jax_ops) == 297


def test_registry_is_jax_minus_the_types_still_to_port():
    assert_registry_parity()


def test_registry_parity_ignores_a_type_registered_by_a_user():
    """A stand-in type registered in each registry (as a user's custom
    op, or another test file's, would be) leaves the parity as it was."""
    from paddle_tpu.core import registry as jreg
    from paddle_tpu_torch.core import registry as treg

    name = "user_registered_standin"
    for reg in (jreg, treg):
        assert not reg.has_op(name)
        reg.register_op(name, inputs=["X"], outputs=["Out"])(
            lambda ctx, ins, attrs: {"Out": ins["X"]})
    try:
        assert name in jreg.all_ops() and name in treg.all_ops()
        assert_registry_parity()
    finally:
        for reg in (jreg, treg):
            del reg._OP_REGISTRY[name]
