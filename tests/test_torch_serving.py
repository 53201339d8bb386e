"""The PyTorch port's GenerativeEngine against the JAX package's, on the
CPU: the same tiny GPT and the same carried weights must stream identical
greedy tokens through plain decode, a prefix-cache hit, chunked prefill
of a prompt past the largest bucket and speculative decoding (spec_k 4),
with equal speculative stats; greedy speculative output is bit-exact
against plain decode in the port, also where a round falls back to the
plain decode chunk near the KV capacity; plus the engine contracts
(exact accounting, typed deadline expiry, the draft_fn length
contract)."""
import time

import numpy as np
import pytest

import paddle_tpu as fluid
import paddle_tpu.unique_name as jun
from paddle_tpu import serving as jserving
from paddle_tpu.models.gpt import GptConfig as JGptConfig
from paddle_tpu.models.gpt import build_gpt_generative as j_build

import paddle_tpu_torch as tfluid
import paddle_tpu_torch.unique_name as tun
from paddle_tpu_torch import kernels as K
from paddle_tpu_torch import monitor as tmonitor
from paddle_tpu_torch import serving as tserving
from paddle_tpu_torch.interop import scope_from_numpy
from paddle_tpu_torch.models.gpt import GptConfig as TGptConfig
from paddle_tpu_torch.models.gpt import build_gpt_generative as t_build

KW = dict(batch_slots=2, max_seq=64, page_size=8, prompt_buckets=(16,),
          prefill_chunk=8)
RNG = np.random.RandomState(41)


@pytest.fixture(scope="module")
def nets():
    with jun.guard():
        j = j_build(JGptConfig.tiny(), **KW)
    with tun.guard():
        t = t_build(TGptConfig.tiny(), **KW)
    exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    exe.run(j["startup"], scope=scope)
    params = {v: scope.numpy(v) for v in j["startup"].global_block.vars}
    return j, t, params


def _jax_engine(nets, **gen_kw):
    j, _, params = nets
    scope = fluid.Scope()
    for n, a in params.items():
        scope.set_var(n, a)
    return jserving.GenerativeEngine(
        j, scope=scope, executor=fluid.Executor(fluid.CPUPlace()),
        config=jserving.ServingConfig(max_batch=2, queue_depth=64,
                                      deadline_s=0),
        gen_config=jserving.GenerationConfig(decode_chunk=2, **gen_kw))


def _torch_engine(nets, **gen_kw):
    _, t, params = nets
    scope = scope_from_numpy(params, tfluid.Scope(), tfluid.CPUPlace())
    return tserving.GenerativeEngine(
        t, scope=scope, executor=tfluid.Executor(tfluid.CPUPlace()),
        config=tserving.ServingConfig(queue_depth=64, deadline_s=0),
        gen_config=tserving.GenerationConfig(decode_chunk=2, **gen_kw))


SHARED = RNG.randint(1, 128, 12).astype(np.int64)
SCENARIOS = {
    # name: (engine options, waves of (prompt, max_new); a wave is
    # submitted together and finished before the next starts)
    "plain_decode": (dict(prefix_cache=False, chunked_prefill=False),
                     [[(RNG.randint(1, 128, 3), 9),
                       (RNG.randint(1, 128, 14), 6)],
                      [(RNG.randint(1, 128, 7), 12)]]),
    "prefix_hit": (dict(prefix_cache=True, chunked_prefill=True),
                   [[(np.concatenate([SHARED, [5, 6]]), 8)],
                    [(np.concatenate([SHARED, [7, 8, 9]]), 8)]]),
    "chunked_over_bucket": (dict(prefix_cache=False, chunked_prefill=True),
                            [[(RNG.randint(1, 128, 6), 20),
                              (RNG.randint(1, 128, 30), 8)]]),
    "speculative": (dict(prefix_cache=False, chunked_prefill=False,
                         speculative=True),
                    [[(np.tile(RNG.randint(1, 128, 3), 3), 18),
                      (RNG.randint(1, 128, 11), 12)],
                     [(RNG.randint(1, 128, 5), 16)]]),
}


def _serve(eng, waves):
    eng.warm_up()
    out = []
    with eng:
        for wave in waves:
            futs = [eng.submit(p, max_new_tokens=n) for p, n in wave]
            out += [list(f.result(timeout=120)[0]) for f in futs]
    return out, eng.generation_stats(), eng.accounting()


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_token_streams_match_jax_engine(nets, scenario):
    opts, waves = SCENARIOS[scenario]
    want, jstats, _ = _serve(_jax_engine(nets, **opts), waves)
    got, tstats, acct = _serve(_torch_engine(nets, **opts), waves)
    assert got == [[int(t) for t in w] for w in want]
    assert acct["exact"] and acct["pending"] == 0
    assert acct["completed"] == sum(len(w) for w in waves)
    assert tstats["prefill_chunks"] == jstats["prefill_chunks"]
    assert tstats["prefix_cache"] == jstats["prefix_cache"]
    assert tstats["speculative"] == jstats["speculative"]
    if scenario == "speculative":
        assert tstats["speculative"]["chunks"] > 0
        assert tstats["speculative"]["accepted_tokens"] > 0
    if scenario == "prefix_hit":
        assert tstats["prefix_cache"]["hits"] == 1
    if scenario == "chunked_over_bucket":
        assert tstats["prefill_chunks"] >= 4
    assert tstats["decode_recompiles"] == 0


def test_warm_up_and_stats(nets):
    eng = _torch_engine(nets)
    assert eng.warm_up() == 3            # prefill:16, decode, chunk
    st = eng.generation_stats()
    assert st["compiled_buckets"] == ["chunk:8", "decode:2", "prefill:16"]
    with eng:
        with pytest.raises(RuntimeError, match="started engine"):
            eng.warm_up()
    assert set(K.launch_counts().values()) == {0}


def test_mid_stream_deadline_settles_typed(nets):
    eng = _torch_engine(nets)
    eng.warm_up()
    orig = eng._run_decode_chunk

    def paced():
        time.sleep(0.06)
        orig()

    eng._run_decode_chunk = paced
    with eng:
        fut = eng.submit(np.array([5, 6, 7]), max_new_tokens=40,
                         deadline_s=0.16)
        err = fut.exception(timeout=120)
    assert isinstance(err, tserving.DeadlineExceeded)
    assert 1 <= len(fut.tokens()) < 40
    acct = eng.accounting()
    assert acct["exact"] and acct["deadline_exceeded"] == 1
    assert acct["completed"] == 0 and acct["pending"] == 0


def test_stop_without_drain_settles_every_request_typed(nets):
    eng = _torch_engine(nets)
    eng.warm_up()
    eng.start()
    futs = [eng.submit(RNG.randint(1, 128, 5), max_new_tokens=50)
            for _ in range(4)]
    eng.stop(drain=False)
    for f in futs:
        assert f.done()
        err = f.exception(timeout=5)
        assert err is None or isinstance(err, tserving.EngineStopped)
    acct = eng.accounting()
    assert acct["exact"] and acct["pending"] == 0
    with pytest.raises(tserving.EngineStopped):
        eng.submit(np.array([1, 2]), max_new_tokens=2)


def _run_one(eng, prompt, max_new):
    return [int(t) for t in
            eng.submit(prompt, max_new_tokens=max_new).result(timeout=120)[0]]


def test_speculative_greedy_is_bit_exact_against_plain_decode(nets):
    """The counterpart of the reference's bit-exactness contract
    (tests/test_prefix_spec.py): greedy speculative output equals plain
    decode, exactly, with a non-trivial acceptance and one acceptance
    observation per resident per verify chunk."""
    prompts = [RNG.randint(1, 128, 5 + i) for i in range(4)]
    opts = dict(prefix_cache=False, chunked_prefill=False)
    base = _torch_engine(nets, **opts)
    base.warm_up()
    with base:
        cold = [_run_one(base, p, 16) for p in prompts]
    tmonitor.reset()
    eng = _torch_engine(nets, speculative=True, **opts)
    assert eng.warm_up() == 3            # prefill:16, decode, verify:4
    with eng:
        hot = [_run_one(eng, p, 16) for p in prompts]
    st = eng.generation_stats()
    assert hot == cold
    sp = st["speculative"]
    assert sp["enabled"] and sp["k"] == 4 and sp["chunks"] > 0
    assert sp["accepted_tokens"] > 0
    assert st["decode_recompiles"] == 0
    assert st["compiled_buckets"] == ["decode:2", "prefill:16", "verify:4"]
    h = tmonitor.metric_value("serving_spec_accepted_len", default=None)
    assert h["count"] == sp["chunks"] and h["max"] >= 1
    assert eng.accounting()["exact"]


def test_spec_falls_back_to_plain_decode_near_kv_capacity(nets):
    """A verify chunk that would overflow the KV cache is not dispatched:
    the round runs the plain decode chunk instead, still bit-exact. The
    draft proposes tokens one off the greedy stream, so every verify
    commits exactly one token and the stream is sure to reach the last
    spec_k - 1 rows of the cache."""
    p = np.random.RandomState(5).randint(1, 128, 16)
    max_new = 64 - 16
    opts = dict(prefix_cache=False, chunked_prefill=False)
    base = _torch_engine(nets, **opts)
    base.warm_up()
    with base:
        cold = _run_one(base, p, max_new)
    eng = _torch_engine(nets, speculative=True, **opts)

    def wrong(hist, n):
        j = len(hist) - len(p)
        return [(t + 1) % 128 for t in (cold + [0] * n)[j:j + n]]
    eng.draft_fn = wrong
    eng.warm_up()
    with eng:
        assert _run_one(eng, p, max_new) == cold
    st = eng.generation_stats()
    assert st["speculative"]["chunks"] > 0
    assert st["speculative"]["accepted_tokens"] == 0
    assert st["phase_time"]["decode"]["dispatches"] > 0
    assert eng.accounting()["exact"]


def test_draft_fn_length_contract(nets):
    """A custom draft_fn proposes exactly spec_k - 1 tokens; any draft
    keeps greedy output exact, and a wrong length fails the streams typed
    with the ValueError as the cause."""
    p = RNG.randint(1, 128, 7)
    opts = dict(prefix_cache=False, chunked_prefill=False)
    base = _torch_engine(nets, **opts)
    base.warm_up()
    with base:
        cold = _run_one(base, p, 10)
    seen = []
    eng = _torch_engine(nets, speculative=True, **opts)
    eng.draft_fn = lambda hist, n: seen.append(n) or [int(hist[-1])] * n
    eng.warm_up()
    with eng:
        assert _run_one(eng, p, 10) == cold
    assert seen and set(seen) == {3}
    bad = _torch_engine(nets, speculative=True, **opts)
    bad.draft_fn = lambda hist, n: [1] * (n + 1)
    bad.warm_up()
    with bad:
        err = bad.submit(p, max_new_tokens=10).exception(timeout=120)
    assert isinstance(err, tserving.BatchFailed)
    assert isinstance(err.__cause__, ValueError)
    assert "draft_fn returned 4 tokens, expected 3" in str(err.__cause__)
    assert bad.accounting()["exact"]


def test_submit_validation(nets):
    eng = _torch_engine(nets, chunked_prefill=False, prefix_cache=False)
    with pytest.raises(ValueError, match="bucket"):
        eng.submit(np.arange(1, 30), max_new_tokens=2)
    with pytest.raises(ValueError, match="KV capacity"):
        eng.submit(np.arange(1, 10), max_new_tokens=60)
    with pytest.raises(ValueError, match="1-D"):
        eng.submit(np.zeros((2, 3), np.int64))
