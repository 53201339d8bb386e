"""The PyTorch port stands alone: it imports neither ``jax`` nor
``paddle_tpu`` (``contrib`` and the MLP model included), runs on the CPU
only when asked to, and ``chip_smoke.py`` refuses to report anything
without a GPU."""
import ast
import os
import shutil
import subprocess
import sys

import pytest
import torch

import paddle_tpu_torch as tfluid
from paddle_tpu_torch import kernels as K

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "paddle_tpu_torch")


def _port_sources():
    for root, _, files in os.walk(PORT):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")


def _imported_roots(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_jax_or_paddle_tpu_import_anywhere_in_the_port():
    sources = list(_port_sources())
    scanned = {os.path.relpath(p, PORT) for p in sources}
    assert {os.path.join("contrib", "mixed_precision", "decorator.py"),
            os.path.join("contrib", "mixed_precision", "fp16_lists.py"),
            os.path.join("models", "mlp.py")} <= scanned
    bad = [(os.path.relpath(p, REPO), m) for p in sources
           for m in _imported_roots(p) if m in ("jax", "jaxlib", "paddle_tpu")]
    assert not bad, bad


_TINY_RUN = r"""
import sys
sys.modules["jax"] = None
sys.modules["paddle_tpu"] = None
import numpy as np
import paddle_tpu_torch as fluid
from paddle_tpu_torch import kernels as K
from paddle_tpu_torch.models.gpt import GptConfig, build_gpt_generative

net = build_gpt_generative(GptConfig.tiny(), batch_slots=2, max_seq=32,
                           page_size=8, prompt_buckets=(16,))
exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
exe.run(net["startup"], scope=scope)
for n, (shape, dt) in net["state_vars"].items():
    scope.set_var(n, np.zeros(shape, dt))
pf = net["prefill"][16]
feed = {"prompt_ids": np.ones((2, 16), np.int64),
        "prompt_pos": np.tile(np.arange(16), (2, 1)),
        "prompt_mask": np.ones((2, 16), np.float32),
        "prompt_len": np.full((2, 1), 16, np.int64),
        "slot_mask": np.ones((2, 1), np.float32)}
first = exe.run(pf["main"], feed=feed, fetch_list=[pf["first_token"]],
                scope=scope)[0]
toks = exe.run_chained(net["decode"]["main"], feed={},
                       fetch_list=[net["decode"]["next_token"]], steps=2,
                       scope=scope)[0]
assert first.shape == (2, 1) and toks.shape == (2, 2, 1)
assert scope.numpy("gpt_gen_pos").ravel().tolist() == [18, 18]
from paddle_tpu_torch.models.bert import BertConfig, build_bert_pretrain
bert = build_bert_pretrain(BertConfig.tiny(), seq_len=16)
exe.run(bert["startup"], scope=scope)
ids = np.ones((2, 16), np.int64)
loss = exe.run(bert["main"], feed={
    "src_ids": ids, "pos_ids": ids, "sent_ids": ids * 0,
    "input_mask": np.ones((2, 16), np.float32), "mask_label": ids,
    "next_sent_label": np.ones((2, 1), np.int64)},
    fetch_list=[bert["loss"]], scope=scope)[0]
assert np.isfinite(loss).all()
fluid.set_flags({"FLAGS_epilogue_fusion": True})
infer = bert["main"].clone(for_test=True)
fused = exe.run(infer, feed={
    "src_ids": ids, "pos_ids": ids, "sent_ids": ids * 0,
    "input_mask": np.ones((2, 16), np.float32), "mask_label": ids,
    "next_sent_label": np.ones((2, 1), np.int64)},
    fetch_list=[bert["loss"]], scope=scope)[0]
assert np.isfinite(fused).all()
assert list(exe._fusion_decisions.values())[0].n_fused == 15
from paddle_tpu_torch.contrib import mixed_precision
fluid.set_flags({"FLAGS_epilogue_fusion": False})
amp = build_bert_pretrain(BertConfig.tiny(), seq_len=16, amp=True)
amp_scope = fluid.Scope()
exe.run(amp["startup"], scope=amp_scope)
feed = {"src_ids": ids, "pos_ids": ids, "sent_ids": ids * 0,
        "input_mask": np.ones((2, 16), np.float32), "mask_label": ids,
        "next_sent_label": np.ones((2, 1), np.int64)}
loss = exe.run(amp["main"], feed=feed, fetch_list=[amp["loss"]],
               scope=amp_scope)[0]
assert np.isfinite(loss).all()
fluid.set_flags({"FLAGS_epilogue_fusion": True})
amp_infer = mixed_precision.decorate_program(amp["main"].clone(for_test=True))
assert np.isfinite(exe.run(amp_infer, feed=feed, fetch_list=[amp["loss"]],
                           scope=amp_scope)[0]).all()
from paddle_tpu_torch.models.mlp import build_mnist_mlp
mlp = build_mnist_mlp(hidden=(8,))
exe.run(mlp["startup"], scope=scope)
acc = exe.run(mlp["main"], feed={"img": np.ones((4, 784), np.float32),
                                 "label": np.ones((4, 1), np.int64)},
              fetch_list=[mlp["acc"]], scope=scope)[0]
assert acc.shape == (1,)
assert "jax" not in [m.split(".")[0] for m in sys.modules if sys.modules[m]]
assert set(K.launch_counts().values()) == {0}
print("ok")
"""


def test_port_runs_with_jax_and_paddle_tpu_blocked():
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", _TINY_RUN], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("ok")


# the port's CI gates: the concurrency analysis and the tools over it
GATE_TOOLS = ("torch_lint_concurrency", "torch_lint_program",
              "torch_lint_numerics", "torch_audit_registry",
              "torch_load_check", "torch_fleet_top", "torch_remat_check",
              "torch_mem_report", "torch_metrics_report",
              "torch_trace_check", "torch_timeline", "torch_chaos_check",
              "torch_option_sweep", "torch_gate_probes",
              "torch_remat_bits")

_GATES_RUN = r"""
import importlib.util, os, sys
sys.modules["jax"] = None
sys.modules["paddle_tpu"] = None
from paddle_tpu_torch.analysis import concurrency
rep = concurrency.analyze_package()
assert not [d for d in rep.diagnostics if d.code == "PT800"]
for name in sys.argv[1:]:
    spec = importlib.util.spec_from_file_location(
        name, os.path.join("tools", name + ".py"))
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
assert not [m for m in sys.modules if sys.modules[m] is not None
            and m.split(".")[0] in ("jax", "jaxlib", "paddle_tpu")]
print("ok")
"""


def test_gate_tools_import_no_jax_or_paddle_tpu():
    bad = [(t, m) for t in GATE_TOOLS
           for m in _imported_roots(os.path.join(REPO, "tools", t + ".py"))
           if m in ("jax", "jaxlib", "paddle_tpu")]
    assert not bad, bad
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", _GATES_RUN, *GATE_TOOLS],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("ok")


def test_executor_without_place_means_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        assert tfluid.Executor().device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tfluid.Executor()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tfluid.Executor(tfluid.CUDAPlace(0))
    assert tfluid.Executor(tfluid.CPUPlace()).device.type == "cpu"


def test_cpu_attention_ops_never_launch_kernels():
    K.reset_launch_counts()
    q = torch.randn(4, 8, 16)
    K.flash_attention(q, q, q, causal=True, num_heads=2)
    K.flash_attention_decode(q, q, q, torch.tensor([2, 5]), num_heads=2)
    K.fused_gemm(q[0], q[0].T, activation="gelu")
    assert K.launch_counts() == {"flash_attention_fwd": 0,
                                 "decode_attention": 0,
                                 "flash_attention_dq": 0,
                                 "flash_attention_dkv": 0,
                                 "fused_gemm": 0}


def test_flash_attention_flag_takes_only_auto_or_never(monkeypatch):
    tfluid.set_flags({"FLAGS_use_flash_attention": "never"})
    tfluid.set_flags({"FLAGS_use_flash_attention": "auto"})
    with pytest.raises(ValueError, match="takes one of"):
        tfluid.set_flags({"FLAGS_use_flash_attention": "always"})
    assert tfluid.flags.flag("use_flash_attention") == "auto"
    monkeypatch.setattr(tfluid.flags, "_overrides", {})
    monkeypatch.setenv("FLAGS_use_flash_attention", "sometimes")
    with pytest.raises(ValueError, match="takes one of"):
        tfluid.flags.flag("use_flash_attention")


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_a_gpu_and_prints_no_result(tmp_path,
                                                             alone):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: chip_smoke.py would run for real")
    script = os.path.join(REPO, "chip_smoke.py")
    cwd = REPO
    if alone:
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script, cwd = str(tmp_path / "chip_smoke.py"), str(tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
