"""The port's seq2seq (``models.seq2seq``) against the JAX package's, on
the CPU, at a tiny size: vocab 50, emb 16, hidden 32, length 8, batch 4,
beam 4, max_len 8.

* the training, startup and decode programs' ``to_dict()`` are equal
  (int32 read as int64, source paths dropped, and the decode program's
  ``bs_*_{id(main)}`` var names mapped, since ``id(main)`` differs);
* from the JAX package's initial scope (``interop.scope_from_numpy``),
  three Adam steps give its losses (rtol 1e-5 at step 1, 1e-4 after) and,
  at step 1, every parameter's gradient (atol 1e-5, rtol 1e-4);
* beam-search decoding in the trained scope gives its ``decoded_ids``
  exactly and its ``decoded_scores`` within rtol 1e-5, at its
  ``[max_len + 1, batch * beam]`` shape.
"""
import json

import numpy as np
import pytest

import paddle_tpu as fluid
import paddle_tpu.unique_name as jun
from paddle_tpu.models import seq2seq as jseq

import paddle_tpu_torch as tfluid
import paddle_tpu_torch.unique_name as tun
from paddle_tpu_torch.interop import scope_from_numpy
from paddle_tpu_torch.models import seq2seq as tseq

VOCAB, EMB, HID, LEN, BATCH, BEAM, MAX_LEN = 50, 16, 32, 8, 4, 4, 8
PARAMS = ("src_emb_w", "tgt_emb_w", "enc_cell_w", "dec_cell_w", "proj_w")


def _train(mod, un):
    with un.guard():
        return mod.build_seq2seq_train(VOCAB, VOCAB, EMB, HID, LEN, LEN,
                                       BATCH)


def _infer(mod, un):
    with un.guard():
        return mod.build_seq2seq_infer(VOCAB, VOCAB, EMB, HID, LEN, BATCH,
                                       BEAM, MAX_LEN)


def _normalized(prog):
    """to_dict() without source paths, int32 read as int64 and the
    program's id in var names replaced."""
    d = prog.to_dict()
    for b in d["blocks"]:
        for v in b["vars"]:
            if v["dtype"] == "int32":
                v["dtype"] = "int64"
        for o in b["ops"]:
            o["attrs"].pop("op_callstack", None)
    return json.loads(json.dumps(d).replace(f"_{id(prog)}", "_<main>"))


@pytest.mark.parametrize("which", ["train.main", "train.startup",
                                   "infer.main"])
def test_program_dicts_match_jax(which):
    build, key = which.split(".")
    fn = _train if build == "train" else _infer
    j, t = fn(jseq, jun), fn(tseq, tun)
    assert _normalized(t[key]) == _normalized(j[key])
    if build == "infer":
        names = {v["name"] for b in _normalized(t[key])["blocks"]
                 for v in b["vars"]}
        assert {"bs_sel_ids_<main>", "bs_sel_sc_<main>",
                "bs_parent_<main>"} <= names


@pytest.fixture(scope="module")
def trained():
    j, t = _train(jseq, jun), _train(tseq, tun)
    jexe, jscope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    jexe.run(j["startup"], scope=jscope)
    names = list(j["startup"].global_block.vars)
    state = {n: jscope.numpy(n) for n in names}
    texe, tscope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    scope_from_numpy(state, tscope, tfluid.CPUPlace(), programs=[t["main"]])
    rng = np.random.RandomState(0)
    feed = {k: rng.randint(0, VOCAB, (BATCH, LEN)).astype(np.int64)
            for k in t["feeds"]}
    grads = [p + "@GRAD" for p in PARAMS]
    steps = []
    for step in range(3):
        fetch = [j["loss"].name] + (grads if step == 0 else [])
        jout = jexe.run(j["main"], feed=feed, fetch_list=fetch,
                        scope=jscope)
        tout = texe.run(t["main"], feed=feed, fetch_list=fetch,
                        scope=tscope)
        steps.append(([np.asarray(a) for a in tout],
                      [np.asarray(a) for a in jout]))
    return dict(steps=steps, names=names, jexe=jexe, jscope=jscope,
                texe=texe, tscope=tscope)


def test_adam_steps_match_jax(trained):
    losses = []
    for step, (tout, jout) in enumerate(trained["steps"]):
        np.testing.assert_allclose(tout[0], jout[0],
                                   rtol=1e-5 if step == 0 else 1e-4,
                                   err_msg=f"loss at step {step + 1}")
        losses.append(float(tout[0].reshape(-1)[0]))
    assert losses[2] < losses[1] < losses[0]
    tout, jout = trained["steps"][0]
    for name, a, b in zip(PARAMS, tout[1:], jout[1:]):
        assert a.shape == b.shape and np.abs(a).max() > 0, name
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=1e-4, err_msg=name)
    for n in trained["names"]:
        np.testing.assert_allclose(trained["tscope"].numpy(n),
                                   trained["jscope"].numpy(n),
                                   atol=1e-5, rtol=1e-4, err_msg=n)


def test_beam_search_decode_matches_jax(trained):
    j, t = _infer(jseq, jun), _infer(tseq, tun)
    src = np.random.RandomState(1).randint(0, VOCAB, (BATCH, LEN)) \
        .astype(np.int64)
    jids, jsc = trained["jexe"].run(j["main"], feed={"src_ids": src},
                                    fetch_list=j["fetches"],
                                    scope=trained["jscope"])
    tids, tsc = trained["texe"].run(t["main"], feed={"src_ids": src},
                                    fetch_list=t["fetches"],
                                    scope=trained["tscope"])
    assert tids.shape == tsc.shape == (MAX_LEN + 1, BATCH * BEAM)
    np.testing.assert_array_equal(tids, np.asarray(jids).astype(np.int64))
    np.testing.assert_allclose(tsc, jsc, rtol=1e-5, atol=1e-6)
    assert ((tids >= 0) & (tids < VOCAB)).all()
    for col in tids.T:                      # eos (1) once reached stays
        hit = np.flatnonzero(col == 1)
        if hit.size:
            assert (col[hit[0]:] == 1).all()
    assert (tids[MAX_LEN] == 1).all()       # the unwritten last row


@pytest.mark.parametrize("size", ["tiny", "rnnencdec"])
def test_verifier_findings_match_jax(size):
    """The recurrent op and its grad share one sub-block, the decode's
    While carries tensor arrays: every analysis pass gives the JAX
    package's findings on the training and decode programs (built, never
    run, at the tiny size and at RNNencdec-50's widths), none an error."""
    from paddle_tpu.analysis import verify_program as jverify
    from paddle_tpu.analysis.pass_manager import ALL_ANALYSIS_PASSES as JALL

    from paddle_tpu_torch.analysis import (ALL_ANALYSIS_PASSES, Severity,
                                           verify_program)

    dims = ((VOCAB, EMB, HID, LEN, BATCH, BEAM, MAX_LEN) if size == "tiny"
            else (30000, 620, 1000, 50, 80, 4, 50))
    v, e, h, n, b, beam, ml = dims

    def build(mod, un):
        with un.guard():
            tr = mod.build_seq2seq_train(v, v, e, h, n, n, b)
        with un.guard():
            inf = mod.build_seq2seq_infer(v, v, e, h, n, b, beam, ml)
        return {"train": (tr["main"], [tr["loss"].name]),
                "infer": (inf["main"], inf["fetches"])}

    def findings(diags, prog):
        return sorted((d.code, str(d.severity), d.block_idx, d.op_idx,
                       d.op_type, d.message.replace(str(id(prog)), "<main>")
                       .replace("int32", "int").replace("int64", "int"))
                      for d in diags)

    jp, tp = build(jseq, jun), build(tseq, tun)
    for name, (prog, fetch) in tp.items():
        jprog, jfetch = jp[name]
        td = verify_program(prog, fetch_names=fetch,
                            passes=ALL_ANALYSIS_PASSES)
        jd = jverify(jprog, fetch_names=jfetch, passes=JALL)
        assert findings(td, prog) == findings(jd, jprog), name
        assert not [d for d in td if d.severity == Severity.ERROR], name


def test_safety_net_leaves_arrays_and_the_while_stash_alone():
    """Under FLAGS_check_nan_inf and FLAGS_numerics_witness a training
    step and a decode run as without them: the nan taps, the witness and
    the release skip tensor arrays and the while's stash, which no fetch
    sees."""
    t = _train(tseq, tun)
    infer = _infer(tseq, tun)
    rng = np.random.RandomState(2)
    feed = {k: rng.randint(0, VOCAB, (BATCH, LEN)).astype(np.int64)
            for k in t["feeds"]}
    out = {}
    for flags in ({}, {"FLAGS_check_nan_inf": True,
                       "FLAGS_numerics_witness": True}):
        prev = tfluid.get_flags(["FLAGS_check_nan_inf",
                                 "FLAGS_numerics_witness"])
        tfluid.set_flags(flags)
        try:
            exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
            t["startup"].random_seed = 3
            exe.run(t["startup"], scope=scope)
            loss = exe.run(t["main"], feed=feed, fetch_list=[t["loss"]],
                           scope=scope)[0]
            ids, sc = exe.run(infer["main"],
                              feed={"src_ids": feed["src_ids"]},
                              fetch_list=infer["fetches"], scope=scope)
        finally:
            tfluid.set_flags(prev)
        out[bool(flags)] = (loss, ids, sc)
        assert not any(k.startswith("__while_init_")
                       for k in scope.vars), flags
    for a, b in zip(out[True], out[False]):
        np.testing.assert_array_equal(a, b)
