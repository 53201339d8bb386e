"""The port's warm-start cache (``paddle_tpu_torch.aot_cache``): the
counterpart of the JAX package's serialized AOT executables is the
executor's prepared step (the program after the tuned block triple,
auto-remat, epilogue fusion and verification), saved in the port's own
program serialization. Off by default; the key changes with the
configuration and the feed shapes; corrupt and stale entries degrade to a
cold prepare and are counted; a fresh executor with a warm cache runs
bit-identical to a cold one, for ``run`` and ``run_chained``, for a
fused inference program, a remat training step and the generative
engine. The module's API and counters are the JAX package's. Bit-exact
throughout (host code; the warm and the cold run interpret one program
with the same rules)."""
import json
import os

import numpy as np
import pytest

from paddle_tpu import aot_cache as jaot

import paddle_tpu_torch as tfluid
import paddle_tpu_torch.unique_name as tun
from paddle_tpu_torch import aot_cache

from test_torch_fleet import TORCH, _build_infer, _params, feed
from paddle_tpu_torch.interop import scope_from_numpy


@pytest.fixture(autouse=True)
def _flags_reset():
    from paddle_tpu_torch import flags as tflags

    snap = dict(tflags._overrides)
    yield
    tflags._overrides.clear()
    tflags._overrides.update(snap)
    tflags._set_epoch += 1


def _delta(fn):
    """(hits, misses, saves, errors) deltas around fn()."""
    def read():
        s = aot_cache.cache_stats()
        return (s["hits"], s["misses"], s["saves"], s["errors"])

    before = read()
    out = fn()
    return out, tuple(a - b for a, b in zip(read(), before))


def _infer():
    infer, _, pred = _build_infer(TORCH)
    scope = scope_from_numpy(_params(), tfluid.Scope(), tfluid.CPUPlace())
    return infer, pred, scope


def test_api_and_counters_are_the_jax_modules():
    assert set(aot_cache.__all__) == set(jaot.__all__)
    assert aot_cache.cache_dir_flag() == ""
    assert set(aot_cache.cache_stats()) == {"hits", "misses", "saves",
                                            "errors"}


def test_off_by_default(tmp_path):
    infer, pred, scope = _infer()
    exe = tfluid.Executor(tfluid.CPUPlace())
    _, d = _delta(lambda: exe.run(infer, feed=feed(), fetch_list=[pred],
                                  scope=scope))
    assert d == (0, 0, 0, 0)
    assert exe._aot_memo == {}


@pytest.mark.parametrize("kind", ["run", "chained"])
def test_warm_executor_runs_bit_identical_to_cold(tmp_path, kind):
    tfluid.set_flags({"FLAGS_aot_cache_dir": str(tmp_path)})
    infer, pred, scope = _infer()
    f = feed(rows=3, seed=11)

    def go(exe):
        if kind == "run":
            return exe.run(infer, feed=f, fetch_list=[pred], scope=scope)
        return exe.run_chained(infer, feed=f, fetch_list=[pred], steps=3,
                               scope=scope)

    exe1 = tfluid.Executor(tfluid.CPUPlace())
    out1, d1 = _delta(lambda: go(exe1))
    assert d1 == (0, 1, 1, 0)                # cold: a miss, saved
    assert [p for p in os.listdir(tmp_path) if p.endswith(".prep.json")]
    _, d1b = _delta(lambda: go(exe1))
    assert d1b == (0, 0, 0, 0)               # probed once per executor
    exe2 = tfluid.Executor(tfluid.CPUPlace())
    out2, d2 = _delta(lambda: go(exe2))
    assert d2 == (1, 0, 0, 0)                # warm: loaded
    assert np.array_equal(out1[0], out2[0])
    # the loaded program is one object, so every run reuses one key
    keys = len(exe2._cache)
    go(exe2)
    assert len(exe2._cache) == keys


def test_key_changes_with_config_and_shape():
    infer, pred, _ = _infer()
    flags = (("check_nan_inf", False),)
    parts = ("run", infer, (pred,), flags, ())
    fa = {"x": np.zeros((1, 13), np.float32)}
    k1 = aot_cache.executable_key(parts, fa)
    assert k1 == aot_cache.executable_key(parts, fa)            # stable
    assert k1 != aot_cache.executable_key(
        parts, {"x": np.zeros((2, 13), np.float32)})            # shape
    assert k1 != aot_cache.executable_key(
        parts, {"x": np.zeros((1, 13), np.float64)})            # dtype
    assert k1 != aot_cache.executable_key(
        ("run", infer, (pred,), (("check_nan_inf", True),), ()), fa)
    assert k1 != aot_cache.executable_key(
        ("run", infer, (pred,), flags, (("autotune", "use"),)), fa)
    assert k1 != aot_cache.executable_key(("chained",) + parts[1:], fa)
    assert k1 != aot_cache.executable_key(
        ("run", infer, ("other",), flags, ()), fa)
    other, _, _ = _build_infer(TORCH, hidden=5)
    assert k1 != aot_cache.executable_key(
        ("run", other, (pred,), flags, ()), fa)                 # content


def test_executor_key_follows_the_flags_the_passes_read(tmp_path):
    tfluid.set_flags({"FLAGS_aot_cache_dir": str(tmp_path)})
    infer, pred, scope = _infer()
    exe = tfluid.Executor(tfluid.CPUPlace())
    _, d1 = _delta(lambda: exe.run(infer, feed=feed(), fetch_list=[pred],
                                   scope=scope))
    tfluid.set_flags({"FLAGS_check_nan_inf": True})
    _, d2 = _delta(lambda: exe.run(infer, feed=feed(), fetch_list=[pred],
                                   scope=scope))
    _, d3 = _delta(lambda: exe.run(infer, feed=feed(rows=2),
                                   fetch_list=[pred], scope=scope))
    assert d1[1:3] == d2[1:3] == d3[1:3] == (1, 1)
    assert len(os.listdir(tmp_path)) == 3


def test_corrupt_and_stale_entries_degrade_and_are_counted(tmp_path):
    tfluid.set_flags({"FLAGS_aot_cache_dir": str(tmp_path)})
    infer, pred, scope = _infer()
    f = feed(seed=2)
    out1 = tfluid.Executor(tfluid.CPUPlace()).run(
        infer, feed=f, fetch_list=[pred], scope=scope)
    entries = [os.path.join(tmp_path, p) for p in os.listdir(tmp_path)]
    assert len(entries) == 1
    with open(entries[0]) as fh:
        good = json.load(fh)
    # corrupt: an error, then a cold prepare that publishes again
    with open(entries[0], "w") as fh:
        fh.write("not json")
    out2, d = _delta(lambda: tfluid.Executor(tfluid.CPUPlace()).run(
        infer, feed=f, fetch_list=[pred], scope=scope))
    assert d == (0, 0, 1, 1)
    assert np.array_equal(out1[0], out2[0])
    # malformed but valid JSON: an error too
    with open(entries[0], "w") as fh:
        json.dump({**good, "program": {"blocks": "nope"}}, fh)
    _, d = _delta(lambda: tfluid.Executor(tfluid.CPUPlace()).run(
        infer, feed=f, fetch_list=[pred], scope=scope))
    assert d == (0, 0, 1, 1)
    # stale: written under another torch: a miss, never loaded
    with open(entries[0], "w") as fh:
        json.dump({**good, "versions": good["versions"][:1]
                   + ["0.0.1-alien"] + good["versions"][2:]}, fh)
    out3, d = _delta(lambda: tfluid.Executor(tfluid.CPUPlace()).run(
        infer, feed=f, fetch_list=[pred], scope=scope))
    assert d == (0, 1, 1, 0)
    assert np.array_equal(out1[0], out3[0])
    # an unwritable directory: the save fails, counted, the run serves
    blocker = tmp_path / "file"
    blocker.write_text("x")
    tfluid.set_flags({"FLAGS_aot_cache_dir": str(blocker / "sub")})
    out4, d = _delta(lambda: tfluid.Executor(tfluid.CPUPlace()).run(
        infer, feed=f, fetch_list=[pred], scope=scope))
    assert d == (0, 1, 0, 1)
    assert np.array_equal(out1[0], out4[0])


def _mlp_program():
    from paddle_tpu_torch.models.mlp import build_mnist_mlp

    with tun.guard():
        net = build_mnist_mlp(hidden=(32, 16))
    return net


def test_warm_fused_inference_and_remat_training_bit_identical(tmp_path):
    """The passes' rewrites survive the cache: a fused inference program
    (``FLAGS_epilogue_fusion``) and an auto-remat training step
    (``FLAGS_auto_recompute``: the same parameters after two steps)."""
    tfluid.set_flags({"FLAGS_aot_cache_dir": str(tmp_path),
                      "FLAGS_epilogue_fusion": True,
                      "FLAGS_auto_recompute": True})
    net = _mlp_program()
    rng = np.random.default_rng(0)
    f = {"img": rng.standard_normal((8, 784)).astype(np.float32),
         "label": rng.integers(0, 10, (8, 1)).astype(np.int64)}
    infer = net["main"].clone(for_test=True)
    outs, params = [], []
    for _ in range(2):
        scope = tfluid.Scope()
        exe = tfluid.Executor(tfluid.CPUPlace())
        tfluid.set_flags({"FLAGS_aot_cache_dir": ""})
        exe.run(net["startup"], scope=scope)
        tfluid.set_flags({"FLAGS_aot_cache_dir": str(tmp_path)})
        o = exe.run(infer, feed=f, fetch_list=[net["logits"]], scope=scope)
        losses = [exe.run(net["main"], feed=f, fetch_list=[net["loss"]],
                          scope=scope)[0] for _ in range(2)]
        outs.append((o[0], losses))
        params.append({p.name: scope.numpy(p.name)
                       for p in net["main"].all_parameters()})
    assert aot_cache.cache_stats()["hits"] >= 2
    assert np.array_equal(outs[0][0], outs[1][0])
    for a, b in zip(outs[0][1], outs[1][1]):
        assert np.array_equal(a, b)
    for n in params[0]:
        assert np.array_equal(params[0][n], params[1][n]), n


def test_generative_engine_warm_start_same_tokens(tmp_path):
    """A gpt_tiny replica's warm-up from a warm cache: hits for every
    prepared step, no errors, and the same tokens as the cold engine."""
    from paddle_tpu_torch import serving
    from paddle_tpu_torch.serving.fleet.replica import build_probe

    tfluid.set_flags({"FLAGS_aot_cache_dir": str(tmp_path)})
    toks, deltas = [], []
    for _ in range(2):
        cfg = serving.ServingConfig(max_batch=4, queue_depth=16)
        eng, _ = build_probe("gpt_tiny", cfg, "cpu")
        _, d = _delta(eng.warm_up)
        deltas.append(d)
        with eng:
            toks.append([eng.submit(p, max_new_tokens=5).result(
                timeout=60)[0].tolist() for p in ([3, 1, 4], [1, 5, 9, 2])])
    assert deltas[0][0] == 0 and deltas[0][2] >= 2
    assert deltas[1][0] == deltas[0][2] and deltas[1][1:] == (0, 0, 0)
    assert toks[0] == toks[1]
