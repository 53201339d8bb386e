"""The PyTorch port's GPT programs against the JAX package's, on the CPU.

The same tiny GPT (2 slots, 32-token KV in 8-token pages) is built in both
packages; the JAX startup program's parameters are carried into the port
with ``interop.scope_from_numpy``, so both compute from the same weights.
"""
import numpy as np
import pytest

import paddle_tpu as fluid
import paddle_tpu.unique_name as jun
from paddle_tpu.core.types import np_dtype as j_np_dtype
from paddle_tpu.models.gpt import GptConfig as JGptConfig
from paddle_tpu.models.gpt import build_gpt_generative as j_build

import paddle_tpu_torch as tfluid
import paddle_tpu_torch.unique_name as tun
from paddle_tpu_torch.interop import scope_from_numpy
from paddle_tpu_torch.models.gpt import GptConfig as TGptConfig
from paddle_tpu_torch.models.gpt import build_gpt_generative as t_build

KW = dict(batch_slots=2, max_seq=32, page_size=8, prompt_buckets=(16,),
          fetch_logits=True)
PROGRAMS = ("startup", "prefill", "decode", "chunk", "verify")


def _program(net, which):
    if which == "startup":
        return net["startup"]
    if which == "prefill":
        return net["prefill"][16]["main"]
    return net[which]["main"]


def _normalized(prog):
    """to_dict() without source paths, int32 read as int64 (the JAX
    package runs with 64-bit types off; the port keeps int64)."""
    d = prog.to_dict()
    for b in d["blocks"]:
        for v in b["vars"]:
            if v["dtype"] == "int32":
                v["dtype"] = "int64"
        for o in b["ops"]:
            o["attrs"].pop("op_callstack", None)
    return d


@pytest.fixture(scope="module")
def nets():
    with jun.guard():
        j = j_build(JGptConfig.tiny(), **KW)
    with tun.guard():
        t = t_build(TGptConfig.tiny(), **KW)
    return j, t


@pytest.fixture(scope="module")
def params(nets):
    j, _ = nets
    exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    exe.run(j["startup"], scope=scope)
    names = [v.name for v in j["startup"].global_block.vars.values()]
    return {n: scope.numpy(n) for n in names}


def _sessions(nets, params):
    j, t = nets
    jexe, jscope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    for n, a in params.items():
        jscope.set_var(n, a)
    for n, (shape, dt) in j["state_vars"].items():
        jscope.set_var(n, np.zeros(shape, j_np_dtype(dt)))
    texe, tscope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    state = {n: np.zeros(shape, np.dtype(dt))
             for n, (shape, dt) in t["state_vars"].items()}
    scope_from_numpy({**params, **state}, tscope, tfluid.CPUPlace(),
                     programs=[t["decode"]["main"]])
    return (jexe, jscope), (texe, tscope)


def _prefill_feed(prompts, bucket=16, slot_mask=None):
    B = len(prompts)
    ids = np.zeros((B, bucket), np.int64)
    mask = np.zeros((B, bucket), np.float32)
    plen = np.ones((B, 1), np.int64)
    smask = np.zeros((B, 1), np.float32)
    for b, p in enumerate(prompts):
        ids[b, :len(p)] = p
        mask[b, :len(p)] = 1.0
        plen[b, 0] = len(p)
        smask[b, 0] = 1.0
    if slot_mask is not None:
        smask = slot_mask
    return {"prompt_ids": ids, "prompt_mask": mask, "prompt_len": plen,
            "slot_mask": smask,
            "prompt_pos": np.tile(np.arange(bucket, dtype=np.int64),
                                  (B, 1))}


PROMPTS = [np.random.RandomState(5).randint(1, 128, L).astype(np.int64)
           for L in (5, 11)]


@pytest.mark.parametrize("which", PROGRAMS)
def test_program_dicts_match_jax(nets, which):
    j, t = nets
    assert _normalized(_program(t, which)) == _normalized(_program(j, which))


def _prefill_and_decode(exe, scope, net, steps=3):
    pf, dec = net["prefill"][16], net["decode"]
    first, last = exe.run(pf["main"], feed=_prefill_feed(PROMPTS),
                          fetch_list=[pf["first_token"], pf["last_logits"]],
                          scope=scope)
    logits, toks = [np.asarray(last)], [np.asarray(first)]
    for _ in range(steps):
        lg, nt = exe.run(dec["main"], feed={},
                         fetch_list=[dec["logits"], dec["next_token"]],
                         scope=scope)
        logits.append(np.asarray(lg))
        toks.append(np.asarray(nt))
    return logits, toks


@pytest.mark.parametrize("jax_flash", ["always", "auto"])
def test_prefill_and_decode_logits_match_jax(nets, params, jax_flash):
    """Prefill plus 3 decode steps from carried weights; the JAX side runs
    its Pallas kernels in interpret mode under ``always``."""
    j, t = nets
    (jexe, jscope), (texe, tscope) = _sessions(nets, params)
    fluid.set_flags({"FLAGS_use_flash_attention": jax_flash})
    try:
        jl, jt = _prefill_and_decode(jexe, jscope, j)
    finally:
        fluid.set_flags({"FLAGS_use_flash_attention": "auto"})
    tl, tt = _prefill_and_decode(texe, tscope, t)
    for step, (a, b) in enumerate(zip(tl, jl)):
        np.testing.assert_allclose(a, b, atol=2e-4, rtol=1e-3,
                                   err_msg=f"step {step}")
    for a, b in zip(tt, jt):
        np.testing.assert_array_equal(a, b.astype(np.int64))
    for i in range(TGptConfig.tiny().num_layers):
        for kv in "kv":
            np.testing.assert_allclose(
                tscope.numpy(f"gpt_kv_{kv}_{i}"),
                jscope.numpy(f"gpt_kv_{kv}_{i}"), atol=2e-4, rtol=1e-3)


def test_run_chained_equals_repeated_runs(nets, params):
    _, t = nets
    dec = t["decode"]
    runs = []
    for chained in (True, False):
        _, (exe, scope) = _sessions(nets, params)
        pf = t["prefill"][16]
        exe.run(pf["main"], feed=_prefill_feed(PROMPTS),
                fetch_list=[pf["first_token"]], scope=scope)
        if chained:
            toks = exe.run_chained(dec["main"], feed={},
                                   fetch_list=[dec["next_token"]], steps=3,
                                   scope=scope)[0]
        else:
            toks = np.stack([exe.run(dec["main"], feed={},
                                     fetch_list=[dec["next_token"]],
                                     scope=scope)[0] for _ in range(3)])
        runs.append((toks, scope.numpy("gpt_kv_k_1"), scope.numpy("gpt_gen_pos")))
    assert runs[0][0].shape == (3, 2, 1)
    for a, b in zip(*runs):
        np.testing.assert_array_equal(a, b)


def test_prefill_decode_logits_continuity(nets, params):
    """Decoding token t+1 from the KV cache equals the full-sequence
    forward at the same position (teacher-forced), inside the port."""
    _, t = nets
    _, (exe, scope) = _sessions(nets, params)
    pf, dec = t["prefill"][16], t["decode"]
    first = exe.run(pf["main"], feed=_prefill_feed(PROMPTS),
                    fetch_list=[pf["first_token"]], scope=scope)[0]
    T = 3
    dec_logits, toks = [], [first.copy()]
    for _ in range(T):
        lg, nt = exe.run(dec["main"], feed={},
                         fetch_list=[dec["logits"], dec["next_token"]],
                         scope=scope)
        dec_logits.append(lg)
        toks.append(nt.copy())
    gen = np.concatenate(toks, axis=1)
    full = [np.concatenate([PROMPTS[b], gen[b, :T + 1]]) for b in range(2)]
    all_logits = exe.run(
        pf["main"], feed=_prefill_feed(full,
                                       slot_mask=np.zeros((2, 1), np.float32)),
        fetch_list=[pf["logits"]], scope=scope)[0]
    for step in range(T):
        for b in range(2):
            np.testing.assert_allclose(
                dec_logits[step][b], all_logits[b, len(PROMPTS[b]) + step],
                atol=2e-4, rtol=1e-3, err_msg=f"decode step {step}, seq {b}")
