"""The PyTorch port's ResNet against the JAX package's, on the CPU.

* ``build_resnet(50)``: the train and startup programs' ``to_dict()``
  equal the JAX package's, with ``amp`` off and on (build only).
* ResNet-18 (class_num 10, 64x64 images, batch 4, Momentum at lr 0.01,
  mu 0.9) trains three steps in both packages from the JAX package's
  initial scope (carried with ``interop.scope_from_numpy``): float32
  losses within rtol 1e-4, and every parameter, Momentum velocity and
  batch_norm running stat within atol 2e-5 / rtol 1e-4 after the steps
  (measured: losses within 2e-7, state within 5.5e-6).
* ``amp=True``: the port's step-1 loss within rtol 2e-2 of the JAX
  package's, three finite, falling steps in both, every convolution and
  matrix product of the port's step (forward and generic grads) on bf16
  operands, and the scope left float32.
* The inference clone's fusion decisions and fused program equal the JAX
  package's: both fuse the fc head (mul [.., 2048] @ [2048, 1000] +
  bias). Only the JAX package adds PT755 for it: N = 1000 is not a
  multiple of the TPU kernel's 128-lane tiles, so it runs that chain on
  its dense route, where the port's Hopper kernel, needing only
  N % 4 == 0, takes it (``ROADMAP.md`` Queue C, a difference by design).

Why 64x64 images and lr 0.01, not 32x32 at lr 0.1: at 32x32 the last
stage is 1x1, so batch_norm normalizes over 4 values and a step amplifies
rounding. Measured in the JAX package alone on the CPU
(``tools/torch_resnet_conditioning.py``), scaling the input by (1 + 1e-7)
moves its own step-3 loss by 1.1e-3 at lr 0.1 (32x32) and by 1.2e-4 at
lr 0.1 (64x64); at 64x64 and lr 0.01 by 3.9e-6.

Why the bf16 tolerance is 2e-2 and covers step 1 only: the two packages
sum each bf16 convolution in a different order before rounding, so single
outputs differ by one bf16 step (2**-8 relative), and over ResNet-18's 20
bf16 convolutions the step-1 logits drift to 4 % of their largest value
(the same tool: step-1 losses 5.5e-3 apart at batch 4, 8.4e-3 at batch
8). After one update the trajectories are as far apart as the JAX package
is from itself: the (1 + 1e-7) input scaling moves its own bf16 step-2
loss by 6.8e-2 at batch 4. So the later steps are held to being finite
and falling.
"""
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import paddle_tpu as fluid
import paddle_tpu.unique_name as jun
from paddle_tpu.analysis.epilogue_fusion import fuse_epilogues as j_fuse
from paddle_tpu.contrib import mixed_precision as jmp
from paddle_tpu.models.resnet import build_resnet as j_build

import paddle_tpu_torch as tfluid
import paddle_tpu_torch.unique_name as tun
from paddle_tpu_torch import executor as texecutor
from paddle_tpu_torch.analysis.epilogue_fusion import fuse_epilogues
from paddle_tpu_torch.contrib import mixed_precision as tmp
from paddle_tpu_torch.interop import scope_from_numpy
from paddle_tpu_torch.models.resnet import build_resnet as t_build
from paddle_tpu_torch.ops.fused_gemm import (fused_gemm_route,
                                             resolve_gemm_blocks)

SMALL = dict(depth=18, class_num=10, image_shape=(3, 64, 64), lr=0.01)
BATCH, STEPS = 4, 3
F32_LOSS_RTOL = 1e-4
F32_STATE_TOL = dict(atol=2e-5, rtol=1e-4)
BF16_STEP1_RTOL = 2e-2


def _normalized(prog):
    """to_dict() without source paths, int32 read as int64."""
    d = prog.to_dict()
    for b in d["blocks"]:
        for v in b["vars"]:
            if v["dtype"] == "int32":
                v["dtype"] = "int64"
        for o in b["ops"]:
            o["attrs"].pop("op_callstack", None)
    return d


def _nets(**kw):
    with jun.guard():
        j = j_build(**kw)
    with tun.guard():
        t = t_build(**kw)
    return j, t


@pytest.mark.parametrize("amp", [False, True])
def test_resnet50_programs_match_jax(amp):
    j, t = _nets(depth=50, amp=amp)
    for which in ("main", "startup"):
        assert _normalized(t[which]) == _normalized(j[which]), which
    types = [op.type for op in t["main"].global_block.ops]
    assert types.count("conv2d") == 53 and types.count("batch_norm") == 53
    assert types.count("momentum") == 161    # 53 convs, 53 x 2 bn, fc w + b
    assert (t["main"]._amp_policy is not None) == amp


def _feed():
    rng = np.random.RandomState(0)
    return {"img": rng.randn(BATCH, 3, 64, 64).astype(np.float32),
            "label": rng.randint(0, 10, (BATCH, 1)).astype(np.int64)}


@pytest.fixture(scope="module", params=[False, True], ids=["f32", "amp"])
def trained(request):
    """Three steps of the JAX package's ResNet-18 (run once per module and
    precision) and the port's program with the JAX initial state."""
    j, t = _nets(amp=request.param, **SMALL)
    jexe, jscope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    jexe.run(j["startup"], scope=jscope)
    names = [v.name for v in j["startup"].global_block.vars.values()]
    init = {n: jscope.numpy(n) for n in names}
    feed = _feed()
    losses = [float(np.ravel(jexe.run(j["main"], feed=feed,
                                      fetch_list=[j["loss"]],
                                      scope=jscope)[0])[0])
              for _ in range(STEPS)]
    return dict(amp=request.param, net=t, init=init, feed=feed,
                losses=losses, state={n: jscope.numpy(n) for n in names})


class _ComputeDtypes(TorchDispatchMode):
    """(op being run, aten op, operand dtypes) of every convolution and
    matrix product on real tensors (shape inference on meta tensors, the
    ``FLAGS_check_program`` verifier's replay, computes nothing)."""

    KINDS = ("convolution", "convolution_backward", "mm", "addmm", "bmm")

    def __init__(self):
        super().__init__()
        self.op, self.seen = None, []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        if name in self.KINDS and not any(
                isinstance(a, torch.Tensor) and a.is_meta for a in args):
            self.seen.append((self.op, name, tuple(
                a.dtype for a in args if isinstance(a, torch.Tensor))))
        return func(*args, **(kwargs or {}))


def _port_steps(trained, monkeypatch):
    t = trained["net"]
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = scope_from_numpy(trained["init"], tfluid.Scope(),
                             tfluid.CPUPlace(), programs=[t["main"]])
    rec = _ComputeDtypes()
    real = texecutor.lower_op

    def tagged(op, env, ctx):
        rec.op = op.type
        real(op, env, ctx)

    def step():
        out = exe.run(t["main"], feed=trained["feed"],
                      fetch_list=[t["loss"]], scope=scope)
        return float(np.ravel(out[0])[0])

    monkeypatch.setattr(texecutor, "lower_op", tagged)
    with rec:
        losses = [step()]
    monkeypatch.undo()
    losses += [step() for _ in range(STEPS - 1)]
    return losses, scope, rec.seen


def test_resnet18_trains_like_jax(trained, monkeypatch):
    losses, scope, seen = _port_steps(trained, monkeypatch)
    want = trained["losses"]
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses
    assert want[-1] < want[0], want
    for n, v in scope.vars.items():
        if v.is_floating_point():
            assert v.dtype == torch.float32, n
    kinds = {(op, name) for op, name, _ in seen}
    assert {("conv2d", "convolution"), ("conv2d_grad", "convolution"),
            ("conv2d_grad", "convolution_backward"), ("mul", "mm"),
            ("mul_grad", "mm")} <= kinds, kinds
    compute = torch.bfloat16 if trained["amp"] else torch.float32
    for op, name, dts in seen:
        # convolution_backward also takes the forward's float32 output
        # grad cast inside the differentiated region: all operands bf16
        assert set(dts) <= {compute}, (op, name, dts)
    if trained["amp"]:
        np.testing.assert_allclose(losses[0], want[0], rtol=BF16_STEP1_RTOL)
        return
    np.testing.assert_allclose(losses, want, rtol=F32_LOSS_RTOL)
    kinds = {"velocity": 0, "running": 0, "param": 0}
    for n, ref in trained["state"].items():
        np.testing.assert_allclose(scope.numpy(n), ref, err_msg=n,
                                   **F32_STATE_TOL)
        kind = ("velocity" if n.startswith("velocity_")
                else "running" if n.startswith("batch_norm")
                and n.endswith(("w_1", "w_2")) else "param")
        kinds[kind] += 1
    # 20 convs + 20 bn x 2 + fc w, b; 20 bn x 2 running stats
    assert kinds == {"velocity": 62, "running": 40, "param": 63}, kinds


@pytest.mark.parametrize("amp", [False, True])
def test_resnet50_inference_fuses_like_jax(amp):
    """The is_test clone (under ``decorate_program`` with ``amp``): both
    packages fuse the fc head (mul [.., 2048] @ [2048, 1000] + bias; its
    output feeds two ops, so nothing after the bias joins) into the same
    fused program. The JAX package notes PT755 for it, N = 1000 not being
    a multiple of its 128-lane tiles, and runs it on the dense route; the
    port's Hopper kernel needs only N % 4 == 0 and takes it at the bench
    batch, on the card."""
    j, t = _nets(depth=50, build_optimizer=False)
    jinf, tinf = j["main"].clone(for_test=True), t["main"].clone(for_test=True)
    if amp:
        jmp.decorate_program(jinf)
        tmp.decorate_program(tinf)
    assert _normalized(tinf) == _normalized(jinf)
    fetch = [t["loss"].name]
    jd, td = [], []
    jdec = j_fuse(jinf, fetch_names=fetch, diags=jd, batch=2)
    tdec = fuse_epilogues(tinf, fetch_names=fetch, diags=td, batch=2)
    assert (tdec.applied, tdec.n_fused, tdec.n_refused, tdec.chains) == (
        jdec.applied, jdec.n_fused, jdec.n_refused, jdec.chains)
    assert (tdec.applied, tdec.n_fused) == (True, 1), tdec.reason
    assert _normalized(tdec.program) == _normalized(jdec.program)
    pt755 = [d for d in jd if d.code == "PT755"]
    assert len(pt755) == 1 and "n=1000" in str(pt755[0]), pt755
    assert sorted(d.code for d in td) == sorted(
        d.code for d in jd if d.code != "PT755")
    (fused,) = [op for op in tdec.program.global_block.ops
                if op.type == "fused_gemm_epilogue"]
    assert fused.input("Y") == ["fc_0.w_0"]
    for dtype in (torch.float32, torch.bfloat16):
        route, reason = fused_gemm_route(
            128, 1000, 2048, layer_norm=False, blocks=resolve_gemm_blocks(),
            alpha=1.0, dtype=dtype, on_cuda=True)
        assert route == "cuda", reason
