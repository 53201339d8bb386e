"""The PyTorch port's ``trace`` against the JAX package's, on the CPU: a
request submitted to the tiny fc batching engine, and one submitted to
the tiny GPT generative engine, leave the same spans — names, parent
links, trace grouping and outcome attributes — in both packages; the
Chrome and JSONL exports carry the reference's fields; a failed batch
records a flight-recorder incident holding the request's span chain."""
import collections
import json

import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu.unique_name as jun
from paddle_tpu import serving as jserving
from paddle_tpu import trace as jtrace
from paddle_tpu.models.gpt import GptConfig as JGptConfig
from paddle_tpu.models.gpt import build_gpt_generative as j_build
from paddle_tpu.resilience import faults as jfaults

import paddle_tpu_torch as tfluid
import paddle_tpu_torch.unique_name as tun
from paddle_tpu_torch import serving as tserving
from paddle_tpu_torch import trace as ttrace
from paddle_tpu_torch.interop import scope_from_numpy
from paddle_tpu_torch.models.gpt import GptConfig as TGptConfig
from paddle_tpu_torch.models.gpt import build_gpt_generative as t_build
from paddle_tpu_torch.resilience import faults as tfaults

SIDES = {"jax": (jfluid, jun, jserving, jtrace, jfaults),
         "torch": (tfluid, tun, tserving, ttrace, tfaults)}


@pytest.fixture(autouse=True)
def _trace_off_after():
    yield
    for fl, _, _, tr, fa in SIDES.values():
        fl.set_flags({"FLAGS_trace": False})
        tr.get_collector().reset()
        fa.clear_plan()


def _fc_engine(side, params=None):
    fl, un, srv, _, _ = SIDES[side]
    with un.guard():
        main, startup = fl.Program(), fl.Program()
        with fl.program_guard(main, startup):
            x = fl.layers.data("x", shape=[13], dtype="float32")
            pred = fl.layers.fc(x, 4, act="softmax")
        infer = main.clone(for_test=True)
    exe = fl.Executor(fl.CPUPlace())
    if side == "jax":
        scope = fl.Scope()
        exe.run(startup, scope=scope)
    else:
        scope = scope_from_numpy(params, fl.Scope(), fl.CPUPlace())
    eng = srv.ServingEngine(infer, feed_names=["x"], fetch_list=[pred.name],
                            scope=scope, executor=exe,
                            config=srv.ServingConfig(max_batch=4))
    return eng, startup


def _tree(tr, trace_id):
    """[(name, parent name)] of one trace, parents before children."""
    spans = tr.trace_tree(trace_id)
    by_id = {s.span_id: s.name for s in spans}
    return [(s.name, by_id.get(s.parent_id)) for s in spans]


def _all_links(tr):
    by_id = {s.span_id: s.name for s in tr.spans()}
    return collections.Counter((s.name, by_id.get(s.parent_id))
                               for s in tr.spans())


def _serve_fc(side, params):
    fl, _, _, tr, _ = SIDES[side]
    eng, _ = _fc_engine(side, params)
    eng.warm_up()
    fl.set_flags({"FLAGS_trace": True})
    tr.get_collector().reset()
    with eng:
        fut = eng.submit({"x": np.ones((1, 13), np.float32)})
        fut.result(timeout=60)
    req = _tree(tr, fut.trace_id)
    root = tr.trace_tree(fut.trace_id)[0]
    return req, _all_links(tr), dict(root.attrs), fut.trace_id


def test_fc_request_spans_match():
    eng, startup = _fc_engine("jax")
    params = {n: eng._scope.numpy(n) for n in startup.global_block.vars}
    jreq, jall, jattrs, _ = _serve_fc("jax", params)
    treq, tall, tattrs, tid = _serve_fc("torch", params)
    assert treq == jreq
    assert treq[0] == ("serving.request", None)
    assert {n for n, _ in treq} == {"serving.request", "serving.submit",
                                    "serving.enqueue", "serving.dispatch"}
    assert tall == jall
    assert tall[("executor.run", "serving.batch")] == 1
    assert tall[("executor.step", "executor.run")] == 1
    assert tattrs["outcome"] == jattrs["outcome"] == "completed"
    assert tid


GPT_KW = dict(batch_slots=2, max_seq=64, page_size=8, prompt_buckets=(16,),
              prefill_chunk=8, spec_k=4)


def test_gpt_request_spans_match():
    with jun.guard():
        j = j_build(JGptConfig.tiny(), **GPT_KW)
    with tun.guard():
        t = t_build(TGptConfig.tiny(), **GPT_KW)
    exe, scope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    exe.run(j["startup"], scope=scope)
    params = {v: scope.numpy(v) for v in j["startup"].global_block.vars}
    prompt = np.random.RandomState(2).randint(1, 128, 9)
    got = {}
    for side, model in (("jax", j), ("torch", t)):
        fl, _, srv, tr, _ = SIDES[side]
        if side == "jax":
            sc = fl.Scope()
            for n, a in params.items():
                sc.set_var(n, a)
        else:
            sc = scope_from_numpy(params, fl.Scope(), fl.CPUPlace())
        eng = srv.GenerativeEngine(
            model, scope=sc, executor=fl.Executor(fl.CPUPlace()),
            config=srv.ServingConfig(max_batch=2, queue_depth=8,
                                     deadline_s=0),
            gen_config=srv.GenerationConfig(decode_chunk=2,
                                            speculative=True))
        eng.warm_up()
        fl.set_flags({"FLAGS_trace": True})
        tr.get_collector().reset()
        with eng:
            fut = eng.submit(prompt, max_new_tokens=6)
            toks = list(fut.result(timeout=120)[0])
        got[side] = (toks, _tree(tr, fut.trace_id), _all_links(tr))
    assert got["torch"][0] == [int(x) for x in got["jax"][0]]
    assert got["torch"][1] == got["jax"][1]
    assert got["torch"][2] == got["jax"][2]
    names = {n for n, _ in got["torch"][2]}
    assert {"serving.prefill", "serving.spec_verify",
            "executor.run"} <= names


def test_exports_carry_the_reference_fields(tmp_path):
    eng, startup = _fc_engine("jax")
    params = {n: eng._scope.numpy(n) for n in startup.global_block.vars}
    for side in ("jax", "torch"):
        _serve_fc(side, params)
    jev = jtrace.to_chrome_events()
    tev = ttrace.to_chrome_events()
    assert len(tev) == len(jev) > 0
    for a, b in zip(sorted(jev, key=lambda e: e["name"]),
                    sorted(tev, key=lambda e: e["name"])):
        assert set(b) == set(a)
        assert b["name"] == a["name"] and b["ph"] == "X"
        assert set(b["args"]) == set(a["args"])
    n = ttrace.export_chrome(str(tmp_path / "t.json"))
    doc = json.load(open(tmp_path / "t.json"))
    assert n == len(doc["traceEvents"]) and doc["displayTimeUnit"] == "ms"
    m = ttrace.export_jsonl(str(tmp_path / "t.jsonl"))
    rows = [json.loads(line) for line in open(tmp_path / "t.jsonl")]
    assert m == len(rows)
    assert set(rows[0]) == set(jtrace.spans()[0].to_dict())


def test_failed_batch_records_an_incident_with_the_request_chain():
    eng, startup = _fc_engine("jax")
    params = {n: eng._scope.numpy(n) for n in startup.global_block.vars}
    eng, _ = _fc_engine("torch", params)
    eng.warm_up()
    tfluid.set_flags({"FLAGS_trace": True})
    ttrace.get_collector().reset()
    with eng, tfaults.fault_plan_guard("batch_dispatch:1:RuntimeError"):
        fut = eng.submit({"x": np.ones((1, 13), np.float32)})
        err = fut.exception(timeout=60)
    assert isinstance(err, tserving.BatchFailed)
    assert err.trace_id == fut.trace_id
    inc = ttrace.incidents()[-1]
    assert inc["kind"] == "batch_failed" and inc["trace_id"] == fut.trace_id
    assert "serving.dispatch" in {d["name"] for d in inc["trace_chain"]}
    assert eng.accounting()["recent_outcomes"][-1]["trace_id"] == \
        fut.trace_id
