"""The port's convolutions (``ops.common.convolution``, under every conv
op type of ``ops/nn.py`` and ``ops/image.py``), on the CPU.

The helper gives ``F.conv*``'s outputs and gradients, first and second
order; its forward and its backward both launch with cuDNN on its
deterministic algorithms and TF32 off, whatever the process-wide
settings, which it leaves as they were. The card tests in
``tests/test_torch_cuda.py`` hold the same rules to float32 and to their
repeats on cuDNN itself.
"""
import pytest
import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import TorchDispatchMode

import paddle_tpu_torch as fluid
from paddle_tpu_torch.ops.common import convolution

# id -> (input shape, weight shape, bias, stride, padding, dilation,
# groups, transposed)
CASES = {
    "conv2d": ((2, 4, 9, 9), (6, 4, 3, 3), False, [2, 2], [1, 1], [1, 1],
               1, False),
    "conv2d_groups_bias": ((2, 6, 8, 8), (6, 2, 3, 3), True, [1, 1],
                           [1, 1], [2, 2], 3, False),
    "conv2d_transpose": ((2, 4, 5, 5), (4, 3, 4, 4), False, [2, 2], [1, 1],
                         [1, 1], 1, True),
    "conv3d_bias": ((2, 3, 4, 6, 6), (5, 3, 3, 3, 3), True, [1, 1, 1],
                    [1, 1, 1], [1, 1, 1], 1, False),
    "conv3d_transpose": ((1, 4, 3, 3, 3), (4, 2, 2, 2, 2), True,
                         [2, 2, 2], [0, 0, 0], [1, 1, 1], 1, True),
}


def _inputs(case):
    xs, ws, bias = CASES[case][:3]
    g = torch.Generator().manual_seed(len(case))
    xv = torch.randn(xs, generator=g, dtype=torch.float64)
    wv = torch.randn(ws, generator=g, dtype=torch.float64)
    out_c = ws[1] * CASES[case][6] if CASES[case][7] else ws[0]
    bv = torch.randn(out_c, generator=g, dtype=torch.float64) \
        if bias else None
    return [t.requires_grad_() for t in (xv, wv, bv) if t is not None]


def _both(case, ins):
    _, _, _, stride, pad, dil, groups, transposed = CASES[case]
    xv, wv = ins[:2]
    bv = ins[2] if len(ins) > 2 else None
    nd = xv.dim() - 2
    fn = (F.conv_transpose2d, F.conv_transpose3d)[nd - 2] if transposed \
        else (F.conv2d, F.conv3d)[nd - 2]
    kw = dict(stride=stride, padding=pad, dilation=dil, groups=groups)
    return (convolution(xv, wv, bv, transposed=transposed, **kw),
            fn(xv, wv, bv, **kw))


@pytest.mark.parametrize("case", sorted(CASES))
def test_convolution_matches_torch_functional(case):
    """Output, first and second gradients equal ``F.conv*``'s (float64,
    so the two are held tightly)."""
    ins = _inputs(case)
    mine, ref = _both(case, ins)
    torch.testing.assert_close(mine, ref, rtol=1e-12, atol=1e-12)
    ct = torch.randn(ref.shape, generator=torch.Generator().manual_seed(1),
                     dtype=torch.float64)
    g_mine = torch.autograd.grad(mine, ins, ct, create_graph=True)
    g_ref = torch.autograd.grad(ref, ins, ct, create_graph=True)
    for a, b in zip(g_mine, g_ref):
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12)
    # second order: the input gradient's sum against the weight
    gg_mine = torch.autograd.grad(g_mine[0].square().sum(), ins[1])[0]
    gg_ref = torch.autograd.grad(g_ref[0].square().sum(), ins[1])[0]
    torch.testing.assert_close(gg_mine, gg_ref, rtol=1e-10, atol=1e-10)


class _SeenSettings(TorchDispatchMode):
    """Records cuDNN's (deterministic, allow_tf32) at each convolution
    and convolution backward dispatched."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        if name in ("convolution", "convolution_backward"):
            self.seen.append((name, torch.backends.cudnn.deterministic,
                              torch.backends.cudnn.allow_tf32))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("layer", ["conv2d", "conv3d", "conv3d_transpose"])
def test_convolutions_launch_deterministic_without_tf32(layer):
    """A training step of a conv layer through ``Executor.run``, with
    cuDNN's process-wide settings at torch's defaults: every forward and
    backward convolution launches with deterministic on and TF32 off,
    and the settings are torch's defaults again afterwards."""
    L = fluid.layers
    shape = [3, 6, 6] if layer == "conv2d" else [3, 4, 6, 6]
    with fluid.unique_name.guard():
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            xv = L.data("x", shape=shape, dtype="float32")
            y = getattr(L, layer)(xv, num_filters=4, filter_size=2)
            loss = L.mean(y)
            fluid.optimizer.SGD(0.1).minimize(loss)
    exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    exe.run(startup, scope=scope)
    feed = {"x": torch.randn([2] + shape,
                             generator=torch.Generator().manual_seed(0))}
    cudnn = torch.backends.cudnn
    was = cudnn.deterministic, cudnn.allow_tf32
    cudnn.deterministic, cudnn.allow_tf32 = False, True
    try:
        with _SeenSettings() as mode:
            exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
        after = cudnn.deterministic, cudnn.allow_tf32
    finally:
        cudnn.deterministic, cudnn.allow_tf32 = was
    assert {n for n, _, _ in mode.seen} == {"convolution",
                                            "convolution_backward"}
    assert all((d, t) == (True, False) for _, d, t in mode.seen)
    assert after == (False, True)
