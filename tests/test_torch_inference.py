"""The port's inference stack (``paddle_tpu_torch.inference``: the
predictor API over ``io.load_inference_model`` and ``Executor``, and the
export over ``torch.export``) against the JAX package's, on the CPU.

The cases of ``tests/test_inference.py`` run in both packages on one
model: the JAX package's startup weights are carried into the port's
scope (``interop.scope_from_numpy``), so both predict from the same
weights. Predictions agree within rtol 1e-5 / atol 1e-7 (float32, other
summation orders); the port's predictor equals its own ``Executor.run``
exactly, and its export round trip (``export_stablehlo`` ->
``load_stablehlo``) equals the port's predictor within rtol 1e-5, as the
JAX package's StableHLO round trip equals its own. The artifact is a
``torch.export`` archive beside its printed graph (``<path>.txt``, in the
role of the JAX package's ``.mlir``). Then the port's own: BERT-tiny with
``FLAGS_epilogue_fusion`` and a ResNet-18 conv program exported, a model
directory the JAX package wrote loaded by the port's predictor, and the
refusals.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu.unique_name as jun
from paddle_tpu import inference as jinf

import paddle_tpu_torch as tfluid
import paddle_tpu_torch.unique_name as tun
from paddle_tpu_torch import inference as tinf
from paddle_tpu_torch.interop import scope_from_numpy

RTOL, ATOL = 1e-5, 1e-7


def _mlp(fl, un):
    with un.guard():
        main, startup = fl.Program(), fl.Program()
        with fl.program_guard(main, startup):
            x = fl.layers.data("x", shape=[8], dtype="float32")
            h = fl.layers.fc(x, 16, act="relu")
            out = fl.layers.fc(h, 3, act="softmax")
    main.random_seed = 5
    return main, startup, out


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    d = tmp_path_factory.mktemp("model")
    xb = np.random.RandomState(0).randn(4, 8).astype(np.float32)
    res = {"xb": xb}
    jmain, jstart, jout = _mlp(jfluid, jun)
    jexe, jscope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    with jfluid.scope_guard(jscope):
        jexe.run(jstart)
        (res["jref"],) = jexe.run(jmain, feed={"x": xb},
                                  fetch_list=[jout.name])
        jfluid.io.save_inference_model(str(d / "jm"), ["x"], [jout], jexe,
                                       main_program=jmain)
        res["jmeta"] = jinf.export_stablehlo(
            jmain, {"x": ((4, 8), "float32")}, [jout], str(d / "j.hlo"))
        weights = {n: np.asarray(jscope.find_var(n))
                   for n in jscope.vars}
    tmain, tstart, tout = _mlp(tfluid, tun)
    texe, tscope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    texe.run(tstart, scope=tscope)
    scope_from_numpy(weights, tscope, tfluid.CPUPlace(), [tmain])
    with tfluid.scope_guard(tscope):
        (res["tref"],) = texe.run(tmain, feed={"x": xb},
                                  fetch_list=[tout.name])
        tfluid.io.save_inference_model(str(d / "tm"), ["x"], [tout], texe,
                                       main_program=tmain)
        tfluid.io.save_inference_model(str(d / "tc"), ["x"], [tout], texe,
                                       main_program=tmain,
                                       model_filename="model.json",
                                       params_filename="params.npz")
        res["tmeta"] = tinf.export_stablehlo(
            tmain, {"x": ((4, 8), "float32")}, [tout], str(d / "t.pt2"))
    res.update(d=d, jdir=str(d / "jm"), tdir=str(d / "tm"))
    return res


def _config(path, **kw):
    c = tinf.AnalysisConfig(path, **kw)
    c.disable_gpu()
    return c


def test_the_two_packages_start_from_the_same_model(trained):
    np.testing.assert_allclose(trained["tref"], trained["jref"], rtol=RTOL,
                               atol=ATOL)


def test_predictor_run_positional(trained):
    pred = tinf.create_paddle_predictor(_config(trained["tdir"]))
    assert pred.get_input_names() == ["x"]
    (got,) = pred.run([trained["xb"]])
    np.testing.assert_array_equal(got, trained["tref"])
    jc = jinf.AnalysisConfig(trained["jdir"])
    jc.disable_gpu()
    (jgot,) = jinf.create_paddle_predictor(jc).run([trained["xb"]])
    np.testing.assert_allclose(got, jgot, rtol=RTOL, atol=ATOL)
    with pytest.raises(ValueError, match="expected 1 inputs"):
        pred.run([])


def test_predictor_zero_copy_handles(trained):
    pred = tinf.create_paddle_predictor(_config(trained["tdir"]))
    h = pred.get_input_handle("x")
    h.copy_from_cpu(trained["xb"])
    assert h.shape() == [4, 8]
    pred.zero_copy_run()
    out_name = pred.get_output_names()[0]
    got = pred.get_output_tensor(out_name).copy_to_cpu()
    np.testing.assert_array_equal(got, trained["tref"])
    with pytest.raises(KeyError):
        pred.get_input_handle("nope")
    with pytest.raises(RuntimeError, match="output tensor"):
        pred.get_output_handle(out_name).copy_from_cpu(trained["xb"])
    fresh = tinf.create_paddle_predictor(_config(trained["tdir"]))
    with pytest.raises(RuntimeError, match="inputs not set"):
        fresh.run()


def test_predictor_combined_files(trained):
    d = trained["d"]
    pred = tinf.create_paddle_predictor(_config(
        None, prog_file=str(d / "tc" / "model.json"),
        params_file=str(d / "tc" / "params.npz")))
    (got,) = pred.run([trained["xb"]])
    np.testing.assert_array_equal(got, trained["tref"])
    with pytest.raises(ValueError, match="model_dir"):
        tinf.AnalysisPredictor(_config(None))


def test_export_roundtrip_against_the_jax_packages(trained):
    """The port's artifact runs standalone and equals the port's predictor;
    the JAX package's StableHLO round trip equals its own reference; both
    return the same ``{feed_order, fetch_names}``."""
    assert trained["tmeta"] == trained["jmeta"] == {
        "feed_order": ["x"], "fetch_names": [trained["tmeta"][
            "fetch_names"][0]]}
    p = tinf.load_stablehlo(str(trained["d"] / "t.pt2"))
    assert isinstance(p, tinf.StableHLOPredictor)
    (got,) = p.run(trained["xb"])
    np.testing.assert_allclose(got, trained["tref"], rtol=RTOL, atol=ATOL)
    (jgot,) = jinf.load_stablehlo(str(trained["d"] / "j.hlo")).run(
        trained["xb"])
    np.testing.assert_allclose(jgot, trained["jref"], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, jgot, rtol=RTOL, atol=ATOL)
    txt = open(str(trained["d"] / "t.pt2") + ".txt").read()
    assert "def forward" in txt and "torch.ops.aten" in txt


def test_a_model_the_jax_package_saved_loads_in_the_port(trained):
    """One inference-model format: the port's predictor runs a directory
    the JAX package wrote."""
    pred = tinf.create_paddle_predictor(_config(trained["jdir"]))
    (got,) = pred.run([trained["xb"]])
    np.testing.assert_allclose(got, trained["jref"], rtol=RTOL, atol=ATOL)


def test_refusals():
    c = tinf.AnalysisConfig("unused")
    with pytest.raises(NotImplementedError, match="export_stablehlo"):
        c.enable_tensorrt_engine(workspace_size=1 << 20)
    assert c.use_gpu()
    c.enable_use_gpu(100, device_id=0)
    assert c.use_gpu()
    c.disable_gpu()
    assert not c.use_gpu()


def test_the_default_place_is_the_card(trained):
    if torch.cuda.is_available():
        pytest.skip("checks the refusal where CUDA is missing")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tinf.create_paddle_predictor(tinf.AnalysisConfig(trained["tdir"]))


def _bert_feed(vocab, B, S):
    rng = np.random.RandomState(0)
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


@pytest.mark.parametrize("fused", [False, True])
def test_bert_tiny_predictor_and_export(tmp_path, fused):
    """BERT-tiny inference through the predictor equals ``Executor.run``
    exactly, with and without ``FLAGS_epilogue_fusion``; the export, made
    under the same flags, equals the predictor within rtol 1e-5."""
    from paddle_tpu_torch.models.bert import BertConfig, build_bert_pretrain

    cfg = BertConfig.tiny()
    with tun.guard():
        net = build_bert_pretrain(cfg, seq_len=32, build_optimizer=False)
    prog = net["main"].clone(for_test=True)
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    exe.run(net["startup"], scope=scope)
    feed = _bert_feed(cfg.vocab_size, 2, 32)
    fetch = [net["loss"].name, net["mlm_loss"].name]
    tfluid.io.save_inference_model(str(tmp_path / "m"), sorted(feed), fetch,
                                   exe, main_program=prog, scope=scope)
    tfluid.set_flags({"FLAGS_epilogue_fusion": fused})
    try:
        want = exe.run(prog, feed=feed, fetch_list=fetch, scope=scope)
        pred = tinf.create_paddle_predictor(_config(str(tmp_path / "m")))
        got = pred.run([feed[n] for n in pred.get_input_names()])
        meta = tinf.export_stablehlo(
            pred._program, {n: (v.shape, str(v.dtype))
                            for n, v in feed.items()},
            pred.get_output_names(), str(tmp_path / "a.pt2"),
            scope=pred._scope)
        if fused:
            assert any(d.applied for d in pred._exe._fusion_decisions.values())
    finally:
        tfluid.set_flags({"FLAGS_epilogue_fusion": False})
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert meta["feed_order"] == sorted(feed)
    art = tinf.load_stablehlo(str(tmp_path / "a.pt2"))
    outs = art.run(*[feed[n] for n in meta["feed_order"]])
    for g, w in zip(outs, got):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=1e-6)


def test_conv_program_export(tmp_path):
    """A ResNet-18 inference program (convolutions, batch_norm, pooling)
    exported and loaded: the artifact equals the predictor within rtol
    1e-5, and its run leaves cuDNN's process settings as they were."""
    from paddle_tpu_torch.models.resnet import resnet_forward

    with tun.guard():
        main, start = tfluid.Program(), tfluid.Program()
        with tfluid.program_guard(main, start):
            net = resnet_forward(18, 10, (3, 32, 32), is_test=True,
                                 with_label=False)
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    exe.run(start, scope=scope)
    tfluid.io.save_inference_model(str(tmp_path / "m"), ["img"],
                                   [net["logits"]], exe, main_program=main,
                                   scope=scope)
    pred = tinf.create_paddle_predictor(_config(str(tmp_path / "m")))
    img = np.random.RandomState(1).rand(2, 3, 32, 32).astype(np.float32)
    (want,) = pred.run([img])
    tinf.export_stablehlo(pred._program, {"img": (img.shape, "float32")},
                          pred.get_output_names(), str(tmp_path / "a.pt2"),
                          scope=pred._scope)
    cudnn = torch.backends.cudnn
    before = cudnn.allow_tf32, cudnn.deterministic
    (got,) = tinf.load_stablehlo(str(tmp_path / "a.pt2")).run(img)
    assert (cudnn.allow_tf32, cudnn.deterministic) == before
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-6)
