"""The PyTorch port's CUDA kernels against their plain versions, on the
card. These tests import no JAX, so they also run where only PyTorch is
installed:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Without a CUDA device they skip: the kernels have no CPU mode."""
import contextlib
import importlib
import math
import os
import sys

import pytest
import torch

from paddle_tpu_torch import kernels as K
from paddle_tpu_torch.kernels import _build

# the modules (the package re-exports their functions under the same names)
FG = importlib.import_module("paddle_tpu_torch.kernels.fused_gemm")
KD = importlib.import_module("paddle_tpu_torch.kernels.decode_attention")


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    # bf16 products accumulate in f32 throughout, as the JAX package's do
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernels_match_plain_versions(dtype):
    """On the card: both kernels against their plain versions, ragged
    shapes included, at ``K.KERNEL_TOL``."""
    g = _cuda()
    dt = getattr(torch, dtype)
    tol = K.KERNEL_TOL[dt]
    q, k, v = (torch.randn(6, 77, 64, generator=g, device="cuda").to(dt)
               for _ in range(3))
    bias = torch.zeros(2, 77, device="cuda")
    bias[1, 50:] = -10000.0
    for causal in (False, True):
        n0 = K.launch_counts()["flash_attention_fwd"]
        o, lse = K.flash_attention_with_lse(q, k, v, bias=bias, causal=causal,
                                            num_heads=3)
        ro, rl = K.flash_attention_reference(q, k, v, bias=bias,
                                             causal=causal, num_heads=3)
        assert K.launch_counts()["flash_attention_fwd"] == n0 + 1
        torch.testing.assert_close(o.float(), ro.float(), **tol)
        torch.testing.assert_close(lse, rl, atol=1e-4, rtol=1e-3)
    kc, vc = (torch.randn(6, 96, 64, generator=g, device="cuda").to(dt)
              for _ in range(2))
    lens = torch.tensor([1, 90], dtype=torch.int32, device="cuda")
    for q_len in (1, 8, 11):
        qd = torch.randn(6, q_len, 64, generator=g, device="cuda").to(dt)
        o = K.flash_attention_decode(qd, kc, vc, lens, num_heads=3)
        ro = K.decode_attention_reference(
            qd, kc, vc, lens.long().repeat_interleave(3), 64 ** -0.5)
        torch.testing.assert_close(o.float(), ro.float(), **tol)


def _bwd_inputs(g, BH, Sq, Sk, D, dt, q_offset=0, k_offset=0, causal=False,
                num_heads=3):
    q = torch.randn(BH, Sq, D, generator=g, device="cuda").to(dt)
    k, v = (torch.randn(BH, Sk, D, generator=g, device="cuda").to(dt)
            for _ in range(2))
    bias = torch.zeros(BH // num_heads, Sk, device="cuda")
    bias[-1, Sk // 2:] = -10000.0
    o, lse = K.flash_attention_reference(q, k, v, bias=bias, causal=causal,
                                         q_offset=q_offset, k_offset=k_offset,
                                         num_heads=num_heads)
    do = torch.randn(BH, Sq, D, generator=g, device="cuda").to(dt)
    delta = (do.float() * o.float()).sum(-1) - 0.1 * torch.randn(
        BH, Sq, generator=g, device="cuda")
    return q, k, v, bias, do, lse, delta


@pytest.mark.cuda
def test_dropout_masks_are_bit_identical_to_the_plain_version():
    """Each kernel's dropped elements, read off its output, are exactly
    ``dropout_keep``'s: K1 with v = I (o[i, j] = 0 iff dropped), K4 with
    dO = I (dv[j, i] = 0 iff dropped), K3 with k = I and delta = 0
    (dq[i, j] = 0 iff dropped)."""
    g = _cuda()
    BH, S, D, rate, seed = 4, 100, 128, 0.25, 77
    keep = K.dropout_keep(seed, BH, S, S, rate, device="cuda")
    eye = torch.eye(S, D, device="cuda").expand(BH, S, D).contiguous()
    q, k, v = (torch.randn(BH, S, D, generator=g, device="cuda")
               for _ in range(3))
    o, lse = K.flash_attention_with_lse(q, k, eye, dropout_rate=rate,
                                        seed=seed)
    assert torch.equal(o[..., :S] != 0, keep)
    zeros = torch.zeros(BH, S, device="cuda")
    _, dv = K.flash_attention_dkv(q, k, v, None, eye, lse, zeros,
                                  dropout_rate=rate, seed=seed)
    assert torch.equal(dv[..., :S].transpose(1, 2) != 0, keep)
    _, lse_k = K.flash_attention_reference(q, eye, v)
    dq = K.flash_attention_dq(q, eye, v, None, k, lse_k, zeros,
                              dropout_rate=rate, seed=seed)
    assert torch.equal(dq[..., :S] != 0, keep)
    assert 0.7 < keep.float().mean().item() < 0.8


@pytest.mark.cuda
def test_autograd_through_the_kernels_matches_plain_autograd():
    """flash_attention_with_lse on the card (K1 forward, K3/K4 backward)
    against autograd of the plain forward, with an lse cotangent."""
    g = _cuda()
    q, k, v = (torch.randn(8, 128, 64, generator=g, device="cuda")
               .requires_grad_() for _ in range(3))
    bias = torch.zeros(2, 128, device="cuda")
    bias[0, 100:] = -10000.0
    grads = []
    for fn in (K.flash_attention_with_lse, K.flash_attention_reference):
        o, lse = fn(q, k, v, bias=bias, num_heads=4, dropout_rate=0.1,
                    seed=5)
        loss = torch.tanh(o).sum() + torch.sin(lse).sum()
        grads.append(torch.autograd.grad(loss, (q, k, v)))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, **K.KERNEL_TOL[torch.float32])


def _gemm_inputs(g, m, n, k, dt, residual=False):
    x = torch.randn(m, k, generator=g, device="cuda").to(dt)
    y = (torch.randn(k, n, generator=g, device="cuda") / k ** 0.5).to(dt)
    kw = dict(bias=torch.randn(n, generator=g, device="cuda"),
              ln_scale=torch.randn(n, generator=g, device="cuda"),
              ln_bias=torch.randn(n, generator=g, device="cuda"))
    if residual:
        kw["residual"] = torch.randn(m, n, generator=g, device="cuda")
    return x, y, kw


@pytest.mark.cuda
@pytest.mark.parametrize("in_dt,out_dt", [("float32", "float32"),
                                          ("bfloat16", "float32"),
                                          ("bfloat16", "bfloat16"),
                                          ("float32", "bfloat16")])
@pytest.mark.parametrize("epilogue", ["plain", "bias+relu", "bias+gelu",
                                      "bias+gelu_tanh+residual",
                                      "bias+residual+layer_norm",
                                      "bias+gelu+layer_norm"])
@pytest.mark.parametrize("m,n,k", [(77, 132, 36), (300, 260, 300),
                                   (5, 4, 4), (129, FG.LN_MAX_N, 100)])
def test_fused_gemm_matches_its_plain_version(m, n, k, epilogue, in_dt,
                                              out_dt):
    """K5 against its plain version on ragged shapes (M, N and K not
    multiples of the 128 x 256 x 32 tile; n = LN_MAX_N the widest whole row
    the layer_norm variants take), every epilogue, every input/output type,
    at ``K.KERNEL_TOL`` of the output type; each call is one launch."""
    _check_gemm(m, n, k, epilogue, in_dt, out_dt)


def _check_gemm(m, n, k, epilogue, in_dt, out_dt,
                blocks=FG.DEFAULT_BLOCKS):
    g = _cuda()
    dt, odt = getattr(torch, in_dt), getattr(torch, out_dt)
    x, y, kw = _gemm_inputs(g, m, n, k, dt, "residual" in epilogue)
    if "layer_norm" not in epilogue:
        kw.pop("ln_scale"), kw.pop("ln_bias")
    if epilogue == "plain":
        kw.pop("bias")
    args = dict(kw, layer_norm="layer_norm" in epilogue,
                activation=("relu" if "relu" in epilogue else
                            "gelu" if "gelu" in epilogue else "none"),
                gelu_approximate="tanh" in epilogue, out_dtype=odt)
    n0 = K.fused_gemm.launches
    by0 = dict(K.fused_gemm.launches_by_blocks)
    got = K.fused_gemm(x, y, **args, block_m=blocks[0], block_n=blocks[1],
                       block_k=blocks[2])
    assert K.fused_gemm.launches == n0 + 1
    by = K.fused_gemm.launches_by_blocks
    assert {b: c - by0.get(b, 0) for b, c in by.items()
            if c != by0.get(b, 0)} == {tuple(blocks): 1}
    want = K.fused_gemm_reference(x, y, **args)
    torch.cuda.synchronize()
    assert got.dtype == odt and got.shape == (m, n)
    torch.testing.assert_close(got.float(), want.float(),
                               **K.KERNEL_TOL[odt])


@pytest.mark.cuda
@pytest.mark.parametrize("in_dt,out_dt", [("float32", "float32"),
                                          ("bfloat16", "float32"),
                                          ("bfloat16", "bfloat16")])
@pytest.mark.parametrize("m", [1, 32, 33, 200])
@pytest.mark.parametrize("n,k", [(4, 4), (36, 132), (132, 36), (260, 100),
                                 (516, 196)])
def test_fused_gemm_edges_of_the_tile(m, n, k, in_dt, out_dt):
    """The 128 x 256 tile's edges: M of 1, 32, 33 and one not a multiple of
    128; N and K of 4, 36 and 132; K not a multiple of the 32-deep k-tile
    times the 3 stages (100, 196); N past one 256-column tile (260, 516);
    bias + gelu, and the layer_norm variant at m = 33."""
    _check_gemm(m, n, k, "bias+gelu", in_dt, out_dt)
    if m == 33:
        _check_gemm(m, n, k, "bias+residual+layer_norm", in_dt, out_dt)


@pytest.mark.cuda
@pytest.mark.parametrize("blocks", FG.COMPILED_BLOCKS)
@pytest.mark.parametrize("in_dt,out_dt", [("float32", "float32"),
                                          ("bfloat16", "float32"),
                                          ("bfloat16", "bfloat16")])
@pytest.mark.parametrize("epilogue", ["plain", "bias+gelu",
                                      "bias+gelu_tanh+residual",
                                      "bias+residual+layer_norm"])
@pytest.mark.parametrize("m,n,k", [(77, 132, 36), (300, 260, 300),
                                   (129, 516, 196), (128, 1000, 2048)])
def test_fused_gemm_at_every_compiled_triple(m, n, k, epilogue, in_dt,
                                             out_dt, blocks):
    """K5 at each compiled block triple against its plain version (the
    same function for every triple), at ``K.KERNEL_TOL`` of the output
    type: ragged M, N and K at each tile's edges (M past 64 and 128 rows,
    N past 64, 128 and 256 columns, K past the 32- and 64-deep k-tiles),
    ResNet-50's fc head, and the layer_norm variants, which keep their
    own 32-row tiles under every triple. Each call is one launch, counted
    under its triple in ``launches_by_blocks``."""
    _check_gemm(m, n, k, epilogue, in_dt, out_dt, blocks)


@pytest.mark.cuda
def test_fused_gemm_uncompiled_triple_names_the_compiled_list():
    """A triple with no instantiation raises before any launch, naming
    the compiled ones; the entry point itself refuses one too
    (cudaErrorInvalidValue, raised as KernelError)."""
    g = _cuda()
    x = torch.randn(64, 64, generator=g, device="cuda")
    y = torch.randn(64, 64, generator=g, device="cuda")
    n0, by0 = K.fused_gemm.launches, dict(K.fused_gemm.launches_by_blocks)
    for bad in ((256, 128, 32), (64, 64, 64), (32, 32, 32)):
        with pytest.raises(ValueError) as err:
            K.fused_gemm(x, y, block_m=bad[0], block_n=bad[1],
                         block_k=bad[2])
        assert str(list(FG.COMPILED_BLOCKS)) in str(err.value)
    assert K.fused_gemm.launches == n0
    assert K.fused_gemm.launches_by_blocks == by0
    out = torch.empty(64, 64, device="cuda")
    with pytest.raises(_build.KernelError, match="cudaError_t 1"):
        _build.launch("fused_gemm", x.device, x.data_ptr(), y.data_ptr(),
                      None, None, None, None, out.data_ptr(), 64, 64, 64,
                      0, 0, 1e-5, 0, 0, 96, 96, 32, None, 1)


@pytest.mark.cuda
def test_launches_by_blocks_counts_each_triple():
    """``launches_by_blocks`` counts every launch under the triple it ran
    at, beside the total, whatever the epilogue."""
    g = _cuda()
    x = torch.randn(96, 128, generator=g, device="cuda")
    y = torch.randn(128, 192, generator=g, device="cuda")
    n0, by0 = K.fused_gemm.launches, dict(K.fused_gemm.launches_by_blocks)
    want = {}
    for i, blocks in enumerate(FG.COMPILED_BLOCKS):
        for _ in range(i + 1):
            K.fused_gemm(x, y, layer_norm=bool(i % 2), block_m=blocks[0],
                         block_n=blocks[1], block_k=blocks[2])
        want[blocks] = i + 1
    K.fused_gemm(x, y)                       # the default triple
    want[FG.DEFAULT_BLOCKS] += 1
    torch.cuda.synchronize()
    by = K.fused_gemm.launches_by_blocks
    assert {b: by[b] - by0.get(b, 0) for b in by} == want
    assert K.fused_gemm.launches - n0 == sum(want.values())


@pytest.mark.cuda
def test_fused_gemm_refuses_what_the_kernel_does_not_take():
    """Unaligned N or K, a block triple with no compiled instantiation and
    a layer_norm row wider than shared memory raise before any launch."""
    _cuda()
    x = torch.zeros(8, 6, device="cuda")
    n0 = K.fused_gemm.launches
    with pytest.raises(ValueError, match="multiple of 4"):
        K.fused_gemm(x, torch.zeros(6, 8, device="cuda"))
    with pytest.raises(ValueError, match="compiled instantiation"):
        K.fused_gemm(torch.zeros(8, 8, device="cuda"),
                     torch.zeros(8, 8, device="cuda"), block_k=16)
    with pytest.raises(ValueError, match="whole rows"):
        K.fused_gemm(torch.zeros(8, 8, device="cuda"),
                     torch.zeros(8, FG.LN_MAX_N + 4, device="cuda"),
                     layer_norm=True)
    with pytest.raises(TypeError, match="float32 or"):
        K.fused_gemm(torch.zeros(8, 8, device="cuda", dtype=torch.float16),
                     torch.zeros(8, 8, device="cuda", dtype=torch.float16))
    assert K.fused_gemm.launches == n0


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,k", [(8, 1000, 2048), (8, 768, 768),
                                   (8, 3072, 768), (8, 768, 3072)])
def test_fused_gemm_f32_small_m_no_farther_from_exact_than_addmm(m, n, k):
    """At small M the f32 route splits k (``FG.splitk_splits``), as cuBLAS
    does there: K5 + bias at ResNet-50's fc head and at m = 8 of BERT-base's
    three products is no farther from a float64 product of the same
    inputs than ``torch.addmm`` (the largest absolute error over three
    seeds of the fusion witness's inputs, normals x 0.5). One chain over
    all of K was 4-5x farther (tools/torch_k5_small_m_check.py)."""
    import numpy as np

    _cuda()
    assert FG.splitk_splits(m, n, k) > 1
    worst = {"k5": 0.0, "addmm": 0.0}
    for seed in range(3):
        rng = np.random.default_rng(seed)
        draw = lambda *s: torch.from_numpy(  # noqa: E731
            rng.standard_normal(s, dtype=np.float32) * 0.5).cuda()
        x, y, bias = draw(m, k), draw(k, n), draw(n)
        ref = torch.addmm(bias.double(), x.double(), y.double())
        got = {"k5": K.fused_gemm(x, y, bias),
               "addmm": torch.addmm(bias, x, y)}
        for name, t in got.items():
            worst[name] = max(worst[name],
                              float((t.double() - ref).abs().max()))
    assert worst["k5"] <= worst["addmm"], worst


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 8, 33, 64])
@pytest.mark.parametrize("n,k", [(4, 4), (260, 100), (132, 2052),
                                 (1000, 4096)])
def test_fused_gemm_f32_split_k_edges_and_repeats(m, n, k):
    """The split route at its edges (one k-tile, K not a multiple of 32,
    more k-tiles than splits, M = 1 and the largest M that splits), every
    triple (the split route runs a 64-row tiling under each), bias + gelu
    + residual into f32 and bf16, at
    ``K.KERNEL_TOL`` of the plain version, and bit-identical run to run
    (the fixed reduction tree). M = 65 does not split."""
    g = _cuda()
    assert FG.splitk_splits(m, n, k) == min(-(-k // FG.SPLITK_K),
                                            FG.MAX_SPLITS)
    assert FG.splitk_splits(65, n, k) == 1
    assert FG.splitk_splits(m, n, k, layer_norm=True) == 1
    assert FG.splitk_splits(m, n, k, bf16=True) == 1
    for blocks in FG.COMPILED_BLOCKS:
        for out_dt in ("float32", "bfloat16"):
            _check_gemm(m, n, k, "bias+gelu_tanh+residual", "float32",
                        out_dt, blocks)
    x, y, kw = _gemm_inputs(g, m, n, k, torch.float32, residual=True)
    kw.pop("ln_scale"), kw.pop("ln_bias")
    a = K.fused_gemm(x, y, activation="gelu", **kw)
    b = K.fused_gemm(x, y, activation="gelu", **kw)
    assert torch.equal(a, b)


@pytest.mark.cuda
def test_a_failed_launch_raises_through_the_fusion_witness(monkeypatch):
    """The entry point's own error (M = 0: cudaErrorInvalidValue) raises
    KernelError; and when K5 fails in the fusion witness, Executor.run
    raises instead of caching and running the unfused program."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.kernels import _build

    _cuda()
    dev = torch.device("cuda", torch.cuda.current_device())
    with pytest.raises(_build.KernelError, match="cudaError_t 1"):
        _build.launch("fused_gemm", dev, None, None, None, None, None, None,
                      None, 0, 8, 8, 0, 0, 1e-5, 0, 0, *FG.DEFAULT_BLOCKS,
                      None, 1)

    def fc(h, act=None):
        return fluid.layers.fc(h, 128, act=act, param_attr=fluid.ParamAttr(
            initializer=fluid.initializer.TruncatedNormal(0.0, 0.02)))

    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data("x", shape=[128], dtype="float32")
        out = fc(fc(x, "relu"))
    exe, scope = fluid.Executor(), fluid.Scope()
    exe.run(startup, scope=scope)
    monkeypatch.setitem(_build._fns, "fused_gemm", lambda *a: 719)
    prev = fluid.get_flags(["FLAGS_epilogue_fusion"])
    fluid.set_flags({"FLAGS_epilogue_fusion": True})
    try:
        with pytest.raises(Exception) as err:
            exe.run(main, feed={"x": torch.randn(32, 128).numpy()},
                    fetch_list=[out], scope=scope)
    finally:
        fluid.set_flags(prev)
    e = err.value
    while not isinstance(e, _build.KernelError):
        e = e.__cause__
    assert "cudaError_t 719" in str(e)
    assert not exe._fusion_cache and not exe._fusion_decisions


@pytest.mark.cuda
def test_fused_gemm_sums_k_in_order_like_cublas():
    """Each output is one FMA chain over k in order, so with no epilogue
    the kernel matches ``torch.matmul`` (cuBLAS SGEMM, TF32 off) far inside
    ``KERNEL_TOL`` at BERT-base's FFN2 depth (K = 3072)."""
    g = _cuda()
    x = torch.randn(512, 3072, generator=g, device="cuda") * 0.5
    y = torch.randn(3072, 768, generator=g, device="cuda") * 0.5
    got, want = K.fused_gemm(x, y), torch.matmul(x, y)
    err = (got - want).abs().max().item()
    assert err <= 1e-3, err


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D", [8, 40, 64, 128])
@pytest.mark.parametrize("Sq,Sk,causal,q_offset,k_offset,rate", [
    (77, 130, False, 0, 0, 0.0), (130, 77, False, 0, 0, 0.1),
    (100, 100, True, 0, 0, 0.0), (77, 140, True, 60, 0, 0.1),
    (90, 90, True, 0, 30, 0.0)])
def test_flash_forward_edges_of_the_tile(dtype, D, Sq, Sk, causal, q_offset,
                                         k_offset, rate):
    """K1 on S not a multiple of its 64-row tiles, head dims zero-padded up
    to the compiled 64 and 128 (8, 40) and at them, causal with q_offset /
    k_offset (k_offset = 30 leaves the first 30 rows no key: o = 0 and
    lse = -inf there), bias, dropout."""
    g = _cuda()
    dt = getattr(torch, dtype)
    q = torch.randn(6, Sq, D, generator=g, device="cuda").to(dt)
    k, v = (torch.randn(6, Sk, D, generator=g, device="cuda").to(dt)
            for _ in range(2))
    bias = torch.zeros(2, Sk, device="cuda")
    bias[1, Sk // 2:] = -10000.0
    kw = dict(bias=bias, causal=causal, q_offset=q_offset, k_offset=k_offset,
              num_heads=3, dropout_rate=rate, seed=11)
    n0 = K.launch_counts()["flash_attention_fwd"]
    o, lse = K.flash_attention_with_lse(q, k, v, **kw)
    assert K.launch_counts()["flash_attention_fwd"] == n0 + 1
    ro, rl = K.flash_attention_reference(q, k, v, **kw)
    torch.cuda.synchronize()
    assert o.dtype == dt and o.shape == q.shape
    torch.testing.assert_close(o.float(), ro.float(), **K.KERNEL_TOL[dt])
    torch.testing.assert_close(lse, rl, atol=1e-4, rtol=1e-3)
    if k_offset > q_offset and causal:
        dead = k_offset - q_offset
        assert torch.equal(o[:, :dead], torch.zeros_like(o[:, :dead]))
        assert torch.isneginf(lse[:, :dead]).all()
        assert torch.isfinite(lse[:, dead:]).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D", [8, 40, 64, 72, 128])
@pytest.mark.parametrize("Sq,Sk,causal,q_offset,k_offset,rate", [
    (77, 130, False, 0, 0, 0.0), (77, 130, False, 0, 0, 0.1),
    (77, 130, True, 0, 0, 0.0), (77, 130, True, 0, 0, 0.1),
    (77, 130, True, 0, 40, 0.0), (77, 130, True, 40, 0, 0.1),
    (1, 1, False, 0, 0, 0.0), (63, 65, False, 0, 0, 0.1),
    (65, 63, True, 0, 0, 0.0), (130, 1, False, 0, 0, 0.1),
    (1, 130, True, 129, 0, 0.0), (130, 130, True, 0, 0, 0.1),
    (65, 130, True, 60, 0, 0.1), (63, 130, True, 0, 30, 0.0),
    (130, 65, True, 0, 70, 0.1)])
def test_backward_kernels_match_plain_versions(dtype, D, Sq, Sk, causal,
                                               q_offset, k_offset, rate):
    """K3 (dQ) and K4 (dK, dV) against their plain versions: S of 1 and
    either side of the 64-row tiles, head dims zero-padded up to the
    compiled 64 and 128 (8, 40, 72) and at them, bias, causal with q/k
    offsets and dropout. Dead rows: k_offset = 40 (30) leaves the first 40
    (30) query rows no key (lse = -inf: their dQ is 0); k_offset = 70
    leaves rows 0..69 dead and keys 60..64 seen by no query (their dK and
    dV are 0, and K4's walk over the q-tiles starts late)."""
    g = _cuda()
    dt = getattr(torch, dtype)
    tol = K.KERNEL_TOL[dt]
    args = _bwd_inputs(g, 6, Sq, Sk, D, dt, q_offset, k_offset, causal)
    kw = dict(causal=causal, dropout_rate=rate, seed=1234,
              q_offset=q_offset, k_offset=k_offset, num_heads=3)
    n = K.launch_counts()
    dq = K.flash_attention_dq(*args, **kw)
    dk, dv = K.flash_attention_dkv(*args, **kw)
    m = K.launch_counts()
    assert (m["flash_attention_dq"], m["flash_attention_dkv"]) == (
        n["flash_attention_dq"] + 1, n["flash_attention_dkv"] + 1)
    rdq = K.flash_attention_dq_reference(*args, **kw)
    rdk, rdv = K.flash_attention_dkv_reference(*args, **kw)
    torch.cuda.synchronize()
    for got, want in ((dq, rdq), (dk, rdk), (dv, rdv)):
        assert got.dtype == dt and got.shape == want.shape
        assert torch.isfinite(got.float()).all()
        torch.testing.assert_close(got.float(), want.float(), **tol)
    if causal and k_offset > q_offset:
        dead = min(k_offset - q_offset, Sq)
        assert torch.isneginf(args[5][:, :dead]).all()
        assert torch.equal(dq[:, :dead], torch.zeros_like(dq[:, :dead]))
        unseen = max(0, Sk - (q_offset + Sq - k_offset))
        if unseen:
            assert not dk[:, -unseen:].any() and not dv[:, -unseen:].any()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_backward_kernels_are_bit_identical_from_run_to_run(dtype):
    """Each output row is owned by one block and summed in one order (no
    atomics), so two calls on the same inputs give the same bits."""
    g = _cuda()
    dt = getattr(torch, dtype)
    args = _bwd_inputs(g, 24, 200, 200, 64, dt)
    kw = dict(dropout_rate=0.1, seed=9, num_heads=3)
    first = (K.flash_attention_dq(*args, **kw),
             *K.flash_attention_dkv(*args, **kw))
    second = (K.flash_attention_dq(*args, **kw),
              *K.flash_attention_dkv(*args, **kw))
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("S", [1, 77, 128])
def test_flash_chain_on_a_fully_padded_row(dtype, rate, S):
    """Every key of batch item 1 carries BERT's -10000 padding bias, so its
    rows see only padded keys and their lse is about -1e4. K1's o and lse,
    then K3 and K4 on K1's lse and delta, against the plain chain (plain
    forward, then the plain backward on its lse) at ``KERNEL_TOL``. lse at
    an absolute 2e-3: two f32 ulps at |lse| = 1e4, which moves P =
    exp(s - lse) in K3/K4 by at most 0.2 %. Both deltas carry the same
    lse cotangent, as ``_bwd_inputs`` does: with one key and dropout, dS =
    P (dP - delta) is otherwise rounding noise, which in bf16 differs
    between a kernel that casts P and a plain version that does not."""
    g = _cuda()
    dt = getattr(torch, dtype)
    tol = K.KERNEL_TOL[dt]
    q, k, v, do = (torch.randn(6, S, 64, generator=g, device="cuda").to(dt)
                   for _ in range(4))
    bias = torch.zeros(2, S, device="cuda")
    bias[1] = -10000.0
    kw = dict(num_heads=3, dropout_rate=rate, seed=17)
    dlse = 0.1 * torch.randn(6, S, generator=g, device="cuda")
    chains = []
    for fwd, dq_fn, dkv_fn in (
            (K.flash_attention_with_lse, K.flash_attention_dq,
             K.flash_attention_dkv),
            (K.flash_attention_reference, K.flash_attention_dq_reference,
             K.flash_attention_dkv_reference)):
        o, lse = fwd(q, k, v, bias=bias, **kw)
        delta = (do.float() * o.float()).sum(-1) - dlse
        args = (q, k, v, bias, do, lse, delta)
        chains.append((o, lse, dq_fn(*args, **kw), *dkv_fn(*args, **kw)))
    torch.cuda.synchronize()
    (o, lse, dq, dk, dv), (ro, rl, rdq, rdk, rdv) = chains
    assert (rl[3:] < -9000).all() and (rl[:3] > -100).all()
    torch.testing.assert_close(lse, rl, atol=2e-3, rtol=0)
    for got, want in ((o, ro), (dq, rdq), (dk, rdk), (dv, rdv)):
        assert torch.isfinite(got.float()).all()
        torch.testing.assert_close(got.float(), want.float(), **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D", [8, 64, 72, 128])
@pytest.mark.parametrize("q_len", [1, 3, 8, 11])
@pytest.mark.parametrize("S", [96, 1000])
def test_decode_kernel_edges_of_the_split(dtype, D, q_len, S):
    """K2 against its plain version. S = 96 is one split (a cluster of one
    block); S = 1000 is 4 splits of 256 keys, the last one ragged, combined
    across the cluster. The lengths: 0 (row 0 sees no key: o = 0), 1, at a
    split boundary and one past it, L + q_len - 1 past S_max, and the whole
    cache; with 2 heads, the b*h of the short lengths have no work in most
    splits. Head dims zero-padded up to the compiled 64 and 128 (8, 72)
    and at them; q_len 11 runs as slices of 8 and 3 rows, one launch each."""
    g = _cuda()
    dt = getattr(torch, dtype)
    split = KD.split_keys(S)
    assert (split, -(-S // split)) == {96: (96, 1), 1000: (256, 4)}[S]
    H = 2
    lens = [0, 1, split, split + 1, S - q_len + 2, S]
    B = len(lens)
    q = torch.randn(B * H, q_len, D, generator=g, device="cuda").to(dt)
    kc, vc = (torch.randn(B * H, S, D, generator=g, device="cuda").to(dt)
              for _ in range(2))
    lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
    n0 = K.launch_counts()["decode_attention"]
    o = K.flash_attention_decode(q, kc, vc, lengths, num_heads=H)
    assert K.launch_counts()["decode_attention"] == n0 + -(-q_len // 8)
    ro = K.decode_attention_reference(q, kc, vc,
                                      lengths.long().repeat_interleave(H),
                                      D ** -0.5)
    torch.cuda.synchronize()
    assert o.dtype == dt and o.shape == q.shape
    torch.testing.assert_close(o.float(), ro.float(), **K.KERNEL_TOL[dt])
    assert torch.equal(o[:H, 0], torch.zeros_like(o[:H, 0]))
    assert torch.isfinite(o.float()).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("q_len", [1, 8])
def test_decode_kernel_is_bit_identical_from_run_to_run(dtype, q_len):
    """The splits are combined in a fixed order through the cluster's
    shared memory (no atomics), so two calls at the serving path's shape
    give the same bits."""
    g = _cuda()
    dt = getattr(torch, dtype)
    q = torch.randn(96, q_len, 64, generator=g, device="cuda").to(dt)
    kc, vc = (torch.randn(96, 1024, 64, generator=g, device="cuda").to(dt)
              for _ in range(2))
    lengths = torch.tensor([1, 8, 9, 16, 333, 700, 1017, 1024],
                           dtype=torch.int32, device="cuda")
    a = K.flash_attention_decode(q, kc, vc, lengths, num_heads=12)
    b = K.flash_attention_decode(q, kc, vc, lengths, num_heads=12)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


# the routes of each source, by the kernel names in its SASS
ROUTES = {"decode_attention": (("decode_kernel_bf16",),
                               ("decode_kernel_f32",)),
          "fused_gemm": (("gemm_bf16_kernel", "gemm_ln_bf16_kernel"),
                         ("gemm_f32_kernel", "gemm_ln_f32_kernel")),
          "flash_attention_fwd": (("flash_fwd_bf16",), ("flash_fwd_f32",)),
          "flash_attention_dq": (("flash_dq_bf16",), ("flash_dq_f32",)),
          "flash_attention_dkv": (("flash_dkv_bf16",), ("flash_dkv_f32",))}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(ROUTES))
def test_tensor_cores_run_the_bf16_routes_only(name):
    """The bf16 routes' SASS holds tensor-core instructions (HMMA or
    HGMMA); the f32 routes' holds none (plain f32 FMAs, no TF32)."""
    _cuda()
    bf16, f32 = ROUTES[name]
    seen = set()
    for fn, text in _build.sass(name).items():
        n = _build.tensor_core_ops(text)
        for kernel in bf16 + f32:
            if kernel in fn:
                seen.add(kernel)
                assert (n > 0) == (kernel in bf16), (fn, n)
    assert seen == set(bf16 + f32)


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,k,epilogue", [
    (16384, 768, 768, "bias"), (16384, 768, 3072, "bias"),
    (16384, 768, 768, "bias+gelu+layer_norm")],
    ids=["qkv_out_proj", "ffn2", "mlm_transform"])
def test_fused_gemm_bf16_at_the_amp_inference_shapes(m, n, k, epilogue):
    """K5's bf16 route with a float32 output at the shapes AMP puts on the
    BERT-base inference path (batch 32 x seq 512 rows; FFN1 has its own
    cases above): x and y cast to bf16, float32 epilogue params."""
    _check_gemm(m, n, k, epilogue, "bfloat16", "float32")


@pytest.mark.cuda
def test_bert_tiny_amp_step_on_the_card():
    """``build_bert_pretrain(amp=True)`` trains on the card: per step K1
    runs twice a layer (forward and the generic grad's rerun) and K3/K4
    once, all on their float32 routes (attention takes float32 Q/K/V
    under AMP); every cuBLAS product takes bf16 operands; parameters and
    Adam moments stay float32; the plain run (FLAGS_use_flash_attention=
    never) from the same weights gives the same first loss within rtol
    1e-4 (the same bf16 products; attention differs only in float32
    summation order) and the loss falls over three steps."""
    from torch.utils._python_dispatch import TorchDispatchMode

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models.bert import BertConfig, build_bert_pretrain

    _cuda()
    cfg = BertConfig.tiny()
    net = build_bert_pretrain(cfg, seq_len=64, amp=True, lr=1e-3)
    init = fluid.Scope()
    fluid.Executor().run(net["startup"], scope=init)
    g = torch.Generator().manual_seed(0)
    feed = {"src_ids": torch.randint(0, cfg.vocab_size, (4, 64),
                                     generator=g).numpy(),
            "pos_ids": torch.arange(64).repeat(4, 1).numpy(),
            "sent_ids": torch.zeros(4, 64, dtype=torch.long).numpy(),
            "input_mask": torch.ones(4, 64).numpy(),
            "mask_label": torch.randint(0, cfg.vocab_size, (4, 64),
                                        generator=g).numpy(),
            "next_sent_label": torch.ones(4, 1, dtype=torch.long).numpy()}

    class Gemms(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.seen = set()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            # products on the card only: FLAGS_check_program's shape
            # replay runs the ops on meta tensors in float32
            tensors = [a for a in args if isinstance(a, torch.Tensor)]
            if func.overloadpacket.__name__ in ("mm", "bmm", "addmm") \
                    and any(a.is_cuda for a in tensors):
                self.seen.add(tuple(a.dtype for a in tensors))
            return func(*args, **(kwargs or {}))

    def run(plain, steps):
        scope = fluid.Scope()
        for n, t in init.vars.items():
            scope.set_var(n, t.clone())
        exe = fluid.Executor()
        prev = fluid.get_flags(["FLAGS_use_flash_attention"])
        fluid.set_flags({"FLAGS_use_flash_attention":
                         "never" if plain else "auto"})
        try:
            K.reset_launch_counts()
            losses = [float(exe.run(net["main"], feed=feed,
                                    fetch_list=[net["loss"]],
                                    scope=scope)[0][0])
                      for _ in range(steps)]
        finally:
            fluid.set_flags(prev)
        return losses, K.launch_counts(), scope

    gemms = Gemms()
    with gemms:
        losses, launches, scope = run(False, 1)
    assert gemms.seen == {(torch.bfloat16, torch.bfloat16)}, gemms.seen
    L = cfg.num_layers
    assert launches["flash_attention_fwd"] == 2 * L
    assert launches["flash_attention_dq"] == launches[
        "flash_attention_dkv"] == L
    assert launches["fused_gemm"] == launches["decode_attention"] == 0
    for n, t in scope.vars.items():
        if t.is_floating_point():
            assert t.dtype == torch.float32, n
    more, _, _ = run(False, 3)
    assert more[2] < more[0] and all(map(math.isfinite, more))
    plain, plain_launches, _ = run(True, 1)
    assert set(plain_launches.values()) == {0}
    assert abs(plain[0] - losses[0]) <= 1e-4 * abs(losses[0])



# -- conv-net ops (cuDNN through F.conv2d) on the card against the CPU ---------

def _rule(op_type, attrs):
    from paddle_tpu_torch.core import registry

    opdef = registry.get_op_def(op_type)
    full = {k: s.default for k, s in opdef.attrs.items()}
    full.update(attrs)
    return opdef, full


def _rule_and_grads(op_type, ins, attrs, out_slot, device, dtype,
                    nhwc="auto"):
    """The port's rule for ``op_type`` on ``device`` with its inputs cast
    to ``dtype``, and the gradients of those inputs for a fixed cotangent
    of ``out_slot`` (what the generic grad computes)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.lowering import LowerCtx

    opdef, full = _rule(op_type, attrs)
    prims = {k: v.to(device=device, dtype=dtype).requires_grad_()
             for k, v in ins.items()}
    prev = fluid.get_flags(["FLAGS_conv_use_nhwc"])
    fluid.set_flags({"FLAGS_conv_use_nhwc": nhwc})
    try:
        with torch.enable_grad():
            y = opdef.lower(LowerCtx(device), {k: [v] for k, v in
                                               prims.items()},
                            full)[out_slot][0]
            ct = torch.randn(y.shape,
                             generator=torch.Generator().manual_seed(5))
            grads = torch.autograd.grad(y, list(prims.values()),
                                        ct.to(device=device, dtype=y.dtype),
                                        allow_unused=True)
    finally:
        fluid.set_flags(prev)
    # a training batch_norm's Y does not depend on the running stats
    return y, {k: g for k, g in zip(prims, grads) if g is not None}


def _conv_cases():
    g = torch.Generator().manual_seed(3)

    def r(*shape, scale=1.0):
        return torch.randn(*shape, generator=g) * scale

    x = r(4, 16, 14, 14)
    # small integers, distinct within every 3x3 window: no ties for max
    # pooling's gradient to break differently once rounded to bf16
    n, c, h, w = torch.meshgrid(*(torch.arange(d) for d in x.shape),
                                indexing="ij")
    distinct = (((h * 14 + w) * 7 + c * 13 + n * 5) % 97 - 48).float()
    return {
        "conv2d": ("conv2d", {"Input": x, "Filter": r(32, 16, 3, 3,
                                                      scale=1 / 12)},
                   {"strides": [2, 2], "paddings": [1, 1]}, "Output"),
        "conv2d_1x1": ("conv2d", {"Input": x, "Filter": r(8, 16, 1, 1,
                                                          scale=0.25)},
                       {}, "Output"),
        "depthwise": ("depthwise_conv2d", {"Input": x, "Filter": r(
            16, 1, 3, 3, scale=1 / 3)}, {"groups": 16, "paddings": [1, 1]},
            "Output"),
        "max_pool": ("pool2d", {"X": distinct}, {
            "ksize": [3, 3], "strides": [2, 2], "paddings": [1, 1]}, "Out"),
        "avg_pool_ceil": ("pool2d", {"X": x}, {
            "pooling_type": "avg", "ksize": [3, 3], "strides": [2, 2],
            "ceil_mode": True, "exclusive": False}, "Out"),
        "global_avg": ("pool2d", {"X": x}, {"pooling_type": "avg",
                                            "global_pooling": True}, "Out"),
        "batch_norm": ("batch_norm", {
            "X": r(4, 16, 7, 7) * 2 + 0.5, "Scale": r(16), "Bias": r(16),
            "Mean": r(16), "Variance": r(16).abs() + 0.5},
            {"momentum": 0.9}, "Y"),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("case,dtype", [
    (c, d) for c in sorted(_conv_cases()) for d in ("float32", "bfloat16")
    # under AMP batch_norm is black-listed: it never computes in bf16
    if not (c == "batch_norm" and d == "bfloat16")])
def test_conv_ops_on_the_card_match_the_cpu(case, dtype):
    """Forward and gradients on ``CUDAPlace(0)`` (channels_last, cuDNN)
    against the CPU in float32 from the same inputs (rounded to bf16 for
    the bf16 case): float32 with TF32 off within ``KERNEL_TOL[f32]``;
    bf16 within ``KERNEL_TOL[bf16]`` (about two bf16 steps). Gradients
    are compared relative to their largest element."""
    _cuda()
    torch.backends.cudnn.allow_tf32 = False
    op_type, ins, attrs, slot = _conv_cases()[case]
    dt = getattr(torch, dtype)
    ins = {k: v.to(dt).float() for k, v in ins.items()}
    ref_y, ref_g = _rule_and_grads(op_type, ins, attrs, slot, "cpu",
                                   torch.float32)
    y, grads = _rule_and_grads(op_type, ins, attrs, slot, "cuda", dt)
    tol = K.KERNEL_TOL[dt]
    torch.testing.assert_close(y.float().cpu(), ref_y, **tol)
    assert set(grads) == set(ref_g)
    for k, g in grads.items():
        scale = ref_g[k].abs().max().clamp_min(1.0)
        torch.testing.assert_close(g.float().cpu() / scale, ref_g[k] / scale,
                                   **tol, msg=k)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(_conv_cases()))
def test_channels_last_matches_contiguous_on_the_card(case):
    """``FLAGS_conv_use_nhwc`` always (channels_last) against never
    (contiguous NCHW) on the card, float32 with TF32 off; the output
    keeps the memory format asked for."""
    _cuda()
    torch.backends.cudnn.allow_tf32 = False
    op_type, ins, attrs, slot = _conv_cases()[case]
    out = {m: _rule_and_grads(op_type, ins, attrs, slot, "cuda",
                              torch.float32, nhwc=m)
           for m in ("always", "never")}
    (y1, g1), (y0, g0) = out["always"], out["never"]
    if op_type != "batch_norm":
        assert y1.is_contiguous(memory_format=torch.channels_last)
        assert y0.is_contiguous()
    tol = K.KERNEL_TOL[torch.float32]
    torch.testing.assert_close(y1, y0, **tol)
    assert set(g1) == set(g0)
    for k in g0:
        torch.testing.assert_close(g1[k], g0[k], **tol, msg=k)


@pytest.mark.cuda
def test_bf16_convolutions_run_bf16_cudnn_kernels():
    """A bf16 conv2d, its generic grad's rerun and backward: every
    convolution kernel the profiler sees is a bf16 one by name
    (``chip_smoke.CONV_MARKS``/``BF16_CONV_MARKS``)."""
    from chip_smoke import conv_class, profile_window

    _cuda()
    op_type, ins, attrs, slot = _conv_cases()["conv2d"]
    with profile_window() as prof:
        _rule_and_grads(op_type, ins, attrs, slot, "cuda", torch.bfloat16)
    classes = {e.key: conv_class(e.key) for e in prof.key_averages()
               if e.device_type.name == "CUDA"}
    convs = {k: c for k, c in classes.items() if c}
    assert convs and set(convs.values()) == {"conv bf16"}, classes


# ---------------------------------------------------------------- serving
def _fc_serving_program(fluid, width=128, act="softmax"):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data("x", shape=[width], dtype="float32")
        h = fluid.layers.fc(x, width, act="relu")
        pred = fluid.layers.fc(h, 16, act=act)
    return main.clone(for_test=True), startup, pred.name


@pytest.mark.cuda
def test_batching_engine_on_the_card_matches_the_cpu():
    """The batching ServingEngine on the card against the same engine on
    the CPU, from the same weights: every request completes, its rows
    within f32 rtol 1e-5 / atol 1e-6 (TF32 off; the two sum in different
    orders), and the parameters stay in the scope on the card."""
    import numpy as np

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import serving

    _cuda()
    infer, startup, pred = _fc_serving_program(fluid)
    init = fluid.Scope()
    fluid.Executor(fluid.CPUPlace()).run(startup, scope=init)
    rng = np.random.RandomState(0)
    feeds = [{"x": rng.rand(r, 128).astype(np.float32)}
             for r in (1, 3, 1, 2, 1, 4, 1)]
    got = {}
    for place in (fluid.CPUPlace(), fluid.CUDAPlace(0)):
        exe = fluid.Executor(place)
        scope = fluid.Scope()
        for n, t in init.vars.items():
            scope.set_var(n, t.to(exe.device))
        eng = serving.ServingEngine(infer, feed_names=["x"],
                                    fetch_list=[pred], scope=scope,
                                    executor=exe,
                                    config=serving.ServingConfig(
                                        max_batch=8))
        assert eng.warm_up() == 4
        with eng:
            outs = [f.result(timeout=120)[0]
                    for f in [eng.submit(fd) for fd in feeds]]
        assert eng.accounting()["exact"]
        assert all(t.device == exe.device for t in scope.vars.values())
        got[place.__class__.__name__] = outs
    for a, b in zip(got["CPUPlace"], got["CUDAPlace"]):
        torch.testing.assert_close(torch.from_numpy(b), torch.from_numpy(a),
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
def test_speculative_decoding_on_the_card_matches_plain_decode():
    """Tiny GPT on the card, greedy: the speculative engine's tokens equal
    the plain engine's up to each request's first near-tie split (a
    position whose top-2 logit gap, from a CPU teacher-forced forward, is
    at most 1e-3: the verify dispatch runs K2's 8-row route and products
    of another M, so the two runs may round a tie apart). K2 launches
    once per layer in every verify dispatch."""
    import numpy as np

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import serving
    from paddle_tpu_torch.models.gpt import (GptConfig,
                                             build_gpt_generative,
                                             build_gpt_prefill)

    _cuda()
    cfg = GptConfig.tiny()
    model = build_gpt_generative(cfg, batch_slots=2, max_seq=64,
                                 page_size=8, prompt_buckets=(16,),
                                 prefill_chunk=8, spec_k=8)
    init = fluid.Scope()
    fluid.Executor(fluid.CPUPlace()).run(model["startup"], scope=init)
    rng = np.random.RandomState(4)
    prompts = [np.tile(rng.randint(1, cfg.vocab_size, 3), 3),
               rng.randint(1, cfg.vocab_size, 11)]

    def serve(spec):
        exe, scope = fluid.Executor(), fluid.Scope()
        for n, t in init.vars.items():
            scope.set_var(n, t.to(exe.device))
        eng = serving.GenerativeEngine(
            model, scope=scope, executor=exe,
            config=serving.ServingConfig(queue_depth=8, deadline_s=0),
            gen_config=serving.GenerationConfig(
                decode_chunk=4, speculative=spec, prefix_cache=False,
                chunked_prefill=False))
        eng.warm_up()
        K.reset_launch_counts()
        with eng:
            outs = [[int(t) for t in f.result(timeout=300)[0]]
                    for f in [eng.submit(p, max_new_tokens=24)
                              for p in prompts]]
        return outs, eng.generation_stats(), K.launch_counts()

    plain, _, _ = serve(False)
    spec, st, launches = serve(True)
    assert st["speculative"]["chunks"] > 0
    # verify dispatches launch K2 once per layer; the plain decode
    # chunks of the fall-back rounds (none here) would add steps * layers
    assert launches["decode_attention"] == \
        cfg.num_layers * st["speculative"]["chunks"]
    net = build_gpt_prefill(cfg, 1, 64, 64, page_size=8, fetch_logits=True)
    cpu = fluid.Executor(fluid.CPUPlace())
    for p, a, b in zip(prompts, plain, spec):
        if a == b:
            continue
        j = next(i for i in range(len(a)) if a[i] != b[i])
        scope = fluid.Scope()
        for n, t in init.vars.items():
            scope.set_var(n, t)
        for n, (shape, dt) in net["state_vars"].items():
            scope.set_var(n, np.zeros(shape, np.dtype(dt)))
        seq = np.concatenate([p, a[:j]])
        L = len(seq)
        feed = {"prompt_ids": np.zeros((1, 64), np.int64),
                "prompt_pos": np.arange(64, dtype=np.int64)[None],
                "prompt_mask": np.zeros((1, 64), np.float32),
                "prompt_len": np.array([[L]], np.int64),
                "slot_mask": np.zeros((1, 1), np.float32)}
        feed["prompt_ids"][0, :L] = seq
        feed["prompt_mask"][0, :L] = 1.0
        lg = cpu.run(net["main"], feed=feed, fetch_list=[net["logits"]],
                     scope=scope, return_numpy=False)[0][0][L - 1]
        top2 = torch.topk(lg, 2).values
        assert float(top2[0] - top2[1]) <= 1e-3, (
            f"speculative and plain decode split at token {j} with a top-2 "
            f"gap of {float(top2[0] - top2[1]):.3e} > 1e-3")


@pytest.mark.cuda
def test_a_kernel_error_inside_a_batch_is_the_cause_of_batch_failed(
        monkeypatch):
    """A K5 launch that fails inside a served batch (FLAGS_epilogue_fusion,
    the launch patched to return cudaError_t 719 after the warm-up's
    witness passed) reaches the caller as the cause of its typed
    BatchFailed; the engine runs the batch nowhere else and keeps
    serving once the kernel works again."""
    import numpy as np

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import serving
    from paddle_tpu_torch.kernels import _build

    _cuda()
    infer, startup, pred = _fc_serving_program(fluid, act="relu")
    exe, scope = fluid.Executor(), fluid.Scope()
    exe.run(startup, scope=scope)
    prev = fluid.get_flags(["FLAGS_epilogue_fusion"])
    fluid.set_flags({"FLAGS_epilogue_fusion": True})
    try:
        eng = serving.ServingEngine(infer, feed_names=["x"],
                                    fetch_list=[pred], scope=scope,
                                    executor=exe,
                                    config=serving.ServingConfig(
                                        max_batch=4, breaker_threshold=5))
        eng.warm_up()
        feed = {"x": np.ones((1, 128), np.float32)}
        with eng:
            real = _build._fns["fused_gemm"]
            monkeypatch.setitem(_build._fns, "fused_gemm", lambda *a: 719)
            n0 = K.launch_counts()["fused_gemm"]
            err = eng.submit(feed).exception(timeout=120)
            monkeypatch.setitem(_build._fns, "fused_gemm", real)
            assert eng.submit(feed).result(timeout=120)[0].shape == (1, 16)
    finally:
        fluid.set_flags(prev)
    assert isinstance(err, serving.BatchFailed)
    e = err.__cause__
    while e is not None and not isinstance(e, _build.KernelError):
        e = e.__cause__ or e.__context__
    assert e is not None and "cudaError_t 719" in str(e)
    assert K.launch_counts()["fused_gemm"] > n0
    acct = eng.accounting()
    assert acct["exact"] and acct["failed"] == 1 and acct["completed"] == 1


# -- auto-remat and the executor's release on the card -------------------------

def _bert_tiny_remat_setup(seq=64, batch=4, **cfg_kw):
    import dataclasses

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models.bert import BertConfig, build_bert_pretrain

    cfg = dataclasses.replace(BertConfig.tiny(), **cfg_kw)
    net = build_bert_pretrain(cfg, seq_len=seq, amp=True, lr=1e-3)
    init = fluid.Scope()
    fluid.Executor(fluid.CPUPlace()).run(net["startup"], scope=init)
    g = torch.Generator().manual_seed(0)
    feed = {"src_ids": torch.randint(0, cfg.vocab_size, (batch, seq),
                                     generator=g).numpy(),
            "pos_ids": torch.arange(seq).repeat(batch, 1).numpy(),
            "sent_ids": torch.zeros(batch, seq, dtype=torch.long).numpy(),
            "input_mask": torch.ones(batch, seq).numpy(),
            "mask_label": torch.randint(0, cfg.vocab_size, (batch, seq),
                                        generator=g).numpy(),
            "next_sent_label": torch.ones(batch, 1,
                                          dtype=torch.long).numpy()}
    return fluid, cfg, net, init, feed


def _remat_run(fluid, net, init, feed, place, auto, steps=1, chained=False):
    scope = fluid.Scope()
    dev = place.torch_device()
    for n, t in init.vars.items():
        scope.set_var(n, t.clone().to(dev))
    exe = fluid.Executor(place)
    prev = fluid.get_flags(["FLAGS_auto_recompute"])
    fluid.set_flags({"FLAGS_auto_recompute": auto})
    try:
        base = 0
        if dev.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
        K.reset_launch_counts()
        if chained:
            out = exe.run_chained(net["main"], feed=feed,
                                  fetch_list=[net["loss"]], steps=steps,
                                  scope=scope)[0].reshape(-1).tolist()
        else:
            out = [float(exe.run(net["main"], feed=feed,
                                 fetch_list=[net["loss"]],
                                 scope=scope)[0].reshape(-1)[0])
                   for _ in range(steps)]
        # the run's own peak: what it allocated above what was resident
        peak = torch.cuda.max_memory_allocated() - base \
            if dev.type == "cuda" else 0
    finally:
        fluid.set_flags(prev)
    return out, K.launch_counts(), peak, exe, scope


@pytest.mark.cuda
def test_bert_tiny_remat_step_on_the_card_matches_the_cpu():
    """BERT-tiny ``amp=True`` under ``FLAGS_auto_recompute`` (dropout off:
    the card's and the CPU's generators draw different bits): the remat
    decision applies, one step's loss and the updated parameters on the
    card match the CPU's (the bf16 products differ in summation order:
    loss rtol 1e-3, parameters atol 2 * lr), and K1 runs twice a layer
    (the segment's forward and its replay), K3/K4 once."""
    _cuda()
    fluid, cfg, net, init, feed = _bert_tiny_remat_setup(
        hidden_dropout=0.0, attention_dropout=0.0)
    card, launches, _, exe, cscope = _remat_run(
        fluid, net, init, feed, fluid.CUDAPlace(0), True)
    cpu, _, _, cexe, hscope = _remat_run(
        fluid, net, init, feed, fluid.CPUPlace(), True)
    ran = next(iter(exe._remat_cache.values()))
    assert ran is not net["main"]
    assert any(op.type == "recompute_segment" for op in ran.global_block.ops)
    assert abs(card[0] - cpu[0]) <= 1e-3 * abs(cpu[0])
    for n in init.vars:
        torch.testing.assert_close(cscope.find_var(n).cpu(),
                                   hscope.find_var(n), atol=2e-3, rtol=0)
    L = cfg.num_layers
    assert launches["flash_attention_fwd"] == 2 * L
    assert launches["flash_attention_dq"] == launches[
        "flash_attention_dkv"] == L


@pytest.mark.cuda
def test_remat_peak_is_below_the_plain_peak_on_the_card():
    _cuda()
    fluid, _, net, init, feed = _bert_tiny_remat_setup(seq=128, batch=16)
    plain, _, plain_peak, _, _ = _remat_run(
        fluid, net, init, feed, fluid.CUDAPlace(0), False)
    remat, _, remat_peak, _, _ = _remat_run(
        fluid, net, init, feed, fluid.CUDAPlace(0), True)
    assert remat_peak < plain_peak
    assert abs(remat[0] - plain[0]) <= 1e-6 * abs(plain[0])


@pytest.mark.cuda
def test_run_chained_holds_memory_flat_with_the_release():
    """Released intermediates do not pile up across the chained loop: the
    run's own peak over 8 chained steps stays within a tenth of its peak
    over 2 (a step's activations are most of it), and the memory held
    after the call does not grow call to call."""
    _cuda()
    fluid, _, net, init, feed = _bert_tiny_remat_setup(seq=128, batch=8)
    _, _, peak2, _, _ = _remat_run(fluid, net, init, feed,
                                   fluid.CUDAPlace(0), False, steps=2,
                                   chained=True)
    out, _, peak8, exe, scope = _remat_run(
        fluid, net, init, feed, fluid.CUDAPlace(0), False, steps=8,
        chained=True)
    assert len(out) == 8 and all(map(math.isfinite, out))
    assert peak8 - peak2 <= peak2 / 10
    held = []
    for _ in range(3):
        exe.run_chained(net["main"], feed=feed, fetch_list=[net["loss"]],
                        steps=4, scope=scope)
        torch.cuda.synchronize()
        held.append(torch.cuda.memory_allocated())
    assert max(held) - min(held) <= 2 ** 20


@pytest.mark.cuda
@pytest.mark.parametrize("height", [2, 512])
def test_embedding_grad_is_bit_identical_from_run_to_run(height):
    """``lookup_table``'s grad sums the rows that share an id in a fixed
    order on the card (a masked sum for a short table, the sorted
    ``index_put_`` otherwise): two runs with heavily repeated ids (and a
    padding id) give the same bits, each element within the f32
    recursive-summation bound of a float64 sum on the CPU: (rows of its
    id - 1) * 2^-24 * the sum of their magnitudes."""
    g = _cuda()
    from paddle_tpu_torch.core import registry
    from paddle_tpu_torch.lowering import LowerCtx

    rule = registry.get_op_def("lookup_table").grad_lower
    w = torch.randn(height, 768, generator=g, device="cuda")
    ids = torch.randint(0, min(height, 8), (32, 512, 1), generator=g,
                        device="cuda")
    dout = torch.randn(32, 512, 768, generator=g, device="cuda")
    ins = {"W": [w], "Ids": [ids], "Out@GRAD": [dout]}
    attrs = {"padding_idx": 1}
    ctx = LowerCtx("cuda")
    a = rule(ctx, ins, attrs)["W@GRAD"][0]
    b = rule(ctx, ins, attrs)["W@GRAD"][0]
    assert torch.equal(a, b)
    host = {k: [v[0].cpu().double() if v[0].is_floating_point()
                else v[0].cpu()] for k, v in ins.items()}
    ref = rule(LowerCtx("cpu"), host, attrs)["W@GRAD"][0]
    mag = rule(LowerCtx("cpu"), dict(host, **{"Out@GRAD": [
        host["Out@GRAD"][0].abs()]}), attrs)["W@GRAD"][0]
    rows = torch.bincount(ids.reshape(-1).cpu(), minlength=height).double()
    bound = (rows - 1).clamp(min=0)[:, None] * 2.0 ** -24 * mag
    assert ((a.cpu().double() - ref).abs() <= bound).all()
    assert not a[1].any() and a[8:].abs().sum() == 0


def _regression_net(fluid):
    import paddle_tpu_torch.unique_name as un

    with un.guard():
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            x = fluid.layers.data("x", shape=[64], dtype="float32")
            y = fluid.layers.data("y", shape=[1], dtype="float32")
            h = fluid.layers.fc(x, 256, act="relu")
            d = fluid.layers.elementwise_sub(fluid.layers.fc(h, 1), y)
            loss = fluid.layers.mean(fluid.layers.elementwise_mul(d, d))
            fluid.optimizer.Adam(1e-3).minimize(loss)
    return main, startup, loss


def _regression_feed(seed, nan=False):
    import numpy as np

    rng = np.random.RandomState(seed)
    x = rng.rand(32, 64).astype(np.float32)
    if nan:
        x[3, 5] = np.nan
    return {"x": x, "y": rng.rand(32, 1).astype(np.float32)}


@pytest.mark.cuda
def test_nan_trip_rolls_the_scope_back_on_the_card():
    """FLAGS_check_nan_inf on the card: a NaN in one feed trips the first
    op that sees it (``mul``), the skip policy leaves every persistable
    bit-identical to its pre-step value, and ``raise`` restores it too."""
    _cuda()
    import paddle_tpu_torch as fluid

    main, startup, loss = _regression_net(fluid)
    exe, scope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
    exe.run(startup, scope=scope)
    prev = fluid.get_flags(["FLAGS_check_nan_inf", "FLAGS_nan_inf_policy"])
    try:
        exe.run(main, feed=_regression_feed(0), fetch_list=[loss],
                scope=scope)
        fluid.set_flags({"FLAGS_check_nan_inf": 1,
                         "FLAGS_nan_inf_policy": "skip"})
        before = {n: scope.find_var(n).clone() for n in scope.vars}
        exe.run(main, feed=_regression_feed(1, nan=True), fetch_list=[loss],
                scope=scope)
        for n, v in before.items():
            assert torch.equal(scope.find_var(n), v), n
        fluid.set_flags({"FLAGS_nan_inf_policy": "raise"})
        with pytest.raises(FloatingPointError, match="op 'mul'"):
            exe.run(main, feed=_regression_feed(1, nan=True),
                    fetch_list=[loss], scope=scope)
        for n, v in before.items():
            assert torch.equal(scope.find_var(n), v), n
        exe.run(main, feed=_regression_feed(2), fetch_list=[loss],
                scope=scope)
        assert any(not torch.equal(scope.find_var(n), v)
                   for n, v in before.items())
    finally:
        fluid.set_flags(prev)


@pytest.mark.cuda
def test_checkpoint_round_trip_on_the_card(tmp_path):
    """save_checkpoint from the card, load_checkpoint into a fresh scope on
    a fresh executor: every persistable bit-identical and back on the
    card, and the next step's loss equal to the saving run's."""
    _cuda()
    import paddle_tpu_torch as fluid

    main, startup, loss = _regression_net(fluid)
    exe, scope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
    exe.run(startup, scope=scope)
    for i in range(2):
        exe.run(main, feed=_regression_feed(i), fetch_list=[loss],
                scope=scope)
    fluid.io.save_checkpoint(exe, str(tmp_path / "checkpoint_2"), main,
                             scope=scope, meta={"step": 2})
    exe2, scope2 = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
    meta = fluid.io.load_checkpoint(exe2, str(tmp_path / "checkpoint_2"),
                                    main, scope=scope2)
    assert meta == {"step": 2}
    for n in scope.vars:
        got = scope2.find_var(n)
        assert got.device.type == "cuda" and torch.equal(
            got, scope.find_var(n)), n
    a = exe.run(main, feed=_regression_feed(5), fetch_list=[loss],
                scope=scope)[0]
    b = exe2.run(main, feed=_regression_feed(5), fetch_list=[loss],
                 scope=scope2)[0]
    assert a.tobytes() == b.tobytes()


# the op types of ops/math.py, ops/optimizer_ops.py and ``where`` that
# the optimizer slice added, each run alone on the card against the port
# on the CPU
OPTIMIZER_SLICE_OPS = (
    "sigmoid exp log square rsqrt ceil floor round reciprocal softplus "
    "softsign sin cos logsigmoid erf tan asin acos atan sinh cosh log1p "
    "expm1 log2 log10 sign silu mish selu stanh brelu hard_shrink "
    "softshrink thresholded_relu maxout leaky_relu relu6 elu hard_sigmoid "
    "swish hard_swish pow log_softmax elementwise_pow elementwise_mod "
    "elementwise_floordiv equal less_than less_equal greater_than "
    "greater_equal logical_and logical_or logical_xor isfinite where "
    "lars_momentum adamw adagrad decayed_adagrad average_accumulates "
    "adadelta adamax rmsprop ftrl lamb").split()
_SCALAR_SLOTS = {"LearningRate", "Beta1Pow", "Beta2Pow"}
_COUNT_SLOTS = {"InNumAccumulates", "InOldNumAccumulates", "InNumUpdates"}


def _op_inputs(op_type, slots, rng):
    """Inputs from ``rng`` for every slot: floats in [0.2, 0.9) (inside
    every unary op's domain), [1] for a rate or a beta power, int64
    counters, bools for a logical op or a condition, int64 for a
    comparison, 4-d for maxout."""
    import numpy as np

    shape = (2, 6, 3, 3) if op_type == "maxout" else (4, 3)
    ins = {}
    for slot in slots:
        if slot in _SCALAR_SLOTS:
            a = np.float32([0.5 if slot == "LearningRate" else 0.81])
        elif slot in _COUNT_SLOTS:
            a = np.array([{"InNumUpdates": 9}.get(slot, 3)], np.int64)
        elif op_type.startswith("logical_") or slot == "Condition":
            a = rng.rand(*shape) > 0.5
        elif op_type.endswith(("equal", "_than")):
            a = rng.randint(0, 3, shape).astype(np.int64)
        else:
            a = rng.uniform(0.2, 0.9, shape).astype(np.float32)
        ins[slot] = a
    return ins


@pytest.mark.cuda
@pytest.mark.parametrize("op_type", OPTIMIZER_SLICE_OPS)
def test_optimizer_slice_op_on_the_card_matches_the_cpu(op_type):
    """Each op type the optimizer slice added, on the card against the
    port on the CPU, float32 rtol 1e-5 (atol 1e-6)."""
    _cuda()
    import numpy as np

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.core import registry

    opdef = registry.get_op_def(op_type)
    ins = _op_inputs(op_type, [s.name for s in opdef.inputs],
                     np.random.RandomState(len(op_type)))
    attrs = {"maxout": {"groups": 3}, "average_accumulates": {
        "min_average_window": 2, "max_average_window": 4}}.get(op_type, {})
    outs = {s.name: [f"o_{s.name}"] for s in opdef.outputs}
    main = fluid.Program()
    blk = main.global_block
    for slot, a in ins.items():
        blk.create_var(name=slot, shape=a.shape, dtype=str(a.dtype),
                       is_data=True)
    for names in outs.values():
        blk.create_var(name=names[0])
    blk.append_op(op_type, inputs={s: [s] for s in ins}, outputs=outs,
                  attrs=attrs)
    fetch = [n[0] for n in outs.values()]
    got = fluid.Executor(fluid.CUDAPlace(0)).run(
        main, feed=ins, fetch_list=fetch, scope=fluid.Scope())
    want = fluid.Executor(fluid.CPUPlace()).run(
        main, feed=ins, fetch_list=fetch, scope=fluid.Scope())
    for n, a, b in zip(fetch, got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, n
        if a.dtype.kind == "f":
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6,
                                       err_msg=n)
        else:
            np.testing.assert_array_equal(a, b, err_msg=n)


@pytest.mark.cuda
def test_merged_step_adds_the_microbatch_gradients_on_the_card():
    """A gradient-merge step (2 microbatches, summed, SGD at rate 1) moves
    every parameter by minus the sum of the two halves' gradients, each
    computed by a plain step on the card: float32 rtol 1e-5."""
    _cuda()
    import numpy as np

    import paddle_tpu_torch as fluid

    def build(merge):
        with fluid.unique_name.guard():
            main, startup = fluid.Program(), fluid.Program()
            with fluid.program_guard(main, startup):
                x = fluid.layers.data("x", shape=[16], dtype="float32")
                y = fluid.layers.data("y", shape=[1], dtype="float32")
                h = fluid.layers.fc(x, 32, act="tanh")
                d = fluid.layers.elementwise_sub(fluid.layers.fc(h, 1), y)
                loss = fluid.layers.mean(fluid.layers.elementwise_mul(d, d))
                opt = fluid.optimizer.SGD(learning_rate=1.0)
                if merge:
                    opt = fluid.optimizer.GradientMergeOptimizer(
                        opt, k_steps=2, avg=False)
                _, pgs = opt.minimize(loss)
        return main, startup, loss, pgs

    rng = np.random.RandomState(0)
    feed = {"x": rng.randn(16, 16).astype(np.float32),
            "y": rng.randn(16, 1).astype(np.float32)}
    main, startup, loss, pgs = build(True)
    exe, scope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
    exe.run(startup, scope=scope)
    init = {n: v.clone() for n, v in scope.vars.items()}
    exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    pmain, _, ploss, ppgs = build(False)
    total = {}
    for half in (slice(0, 8), slice(8, 16)):
        s = fluid.Scope()
        for n, v in init.items():
            s.set_var(n, v.clone())
        grads = fluid.Executor(fluid.CUDAPlace(0)).run(
            pmain, feed={k: v[half] for k, v in feed.items()},
            fetch_list=[g for _, g in ppgs], scope=s)
        for (p, _), g in zip(ppgs, grads):
            total[p.name] = total.get(p.name, 0) + g
    for p, _ in pgs:
        moved = (init[p.name] - scope.find_var(p.name)).cpu().numpy()
        np.testing.assert_allclose(moved, total[p.name], rtol=1e-5,
                                   atol=1e-6, err_msg=p.name)


# -- the control-flow slice: index grads, beam search, a seq2seq step ------

def _index_grad_inputs(op_type, g):
    """Inputs of ``op_type``'s grad rule with heavily repeated indices."""
    if op_type == "lookup_table_v2":
        return {"W": [torch.randn(512, 256, generator=g, device="cuda")],
                "Ids": [torch.randint(0, 8, (64, 128), generator=g,
                                      device="cuda")],
                "Out@GRAD": [torch.randn(64, 128, 256, generator=g,
                                         device="cuda")]}, {"padding_idx": 1}
    x = torch.randn(64, 8, 256, generator=g, device="cuda")
    if op_type == "gather":
        idx = torch.randint(0, 6, (8192,), generator=g, device="cuda")
        return {"X": [x], "Index": [idx], "Out@GRAD": [
            torch.randn(8192, 8, 256, generator=g, device="cuda")]}, {}
    if op_type == "gather_nd":
        idx = torch.randint(0, 4, (8192, 2), generator=g, device="cuda")
        return {"X": [x], "Index": [idx], "Out@GRAD": [
            torch.randn(8192, 256, generator=g, device="cuda")]}, {}
    out_grad = torch.randn(64, 8, 256, generator=g, device="cuda")
    if op_type == "scatter":
        idx = torch.randint(0, 6, (4096,), generator=g, device="cuda")
        return {"X": [x], "Ids": [idx], "Updates": [
            torch.randn(4096, 8, 256, generator=g, device="cuda")],
            "Out@GRAD": [out_grad]}, {"overwrite": False}
    idx = torch.randint(0, 4, (4096, 2), generator=g, device="cuda")
    return {"X": [x], "Index": [idx], "Updates": [
        torch.randn(4096, 256, generator=g, device="cuda")],
        "Out@GRAD": [out_grad]}, {}


@pytest.mark.cuda
@pytest.mark.parametrize("op_type", ["gather", "gather_nd", "scatter",
                                     "scatter_nd_add", "lookup_table_v2"])
def test_index_grads_are_bit_identical_from_run_to_run(op_type):
    """The grad rules of the index ops sum the rows that share an index
    in a fixed order on the card (the sorted ``index_put_``, not
    ``index_add_``'s atomics): two runs with thousands of rows on a few
    indices give the same bits, within float32 rounding of the CPU."""
    g = _cuda()
    from paddle_tpu_torch.core import registry
    from paddle_tpu_torch.lowering import LowerCtx

    rule = registry.get_op_def(op_type).grad_lower
    ins, attrs = _index_grad_inputs(op_type, g)
    a = rule(LowerCtx("cuda"), ins, attrs)
    b = rule(LowerCtx("cuda"), ins, attrs)
    host = rule(LowerCtx("cpu"), {k: [v[0].cpu()] for k, v in ins.items()},
                attrs)
    assert sorted(a) == sorted(host)
    for slot in a:
        assert torch.equal(a[slot][0], b[slot][0]), slot
        torch.testing.assert_close(a[slot][0].cpu(), host[slot][0],
                                   rtol=1e-5, atol=1e-3)


@pytest.mark.cuda
def test_beam_search_on_the_card_breaks_ties_like_the_cpu():
    """Scores on a coarse grid (most candidates tie) and finished beams
    among them: the card picks what the CPU rule picks, ids, scores and
    parents, at the decode's width (80 sources, beam 4, 30000 words)."""
    g = _cuda()
    from paddle_tpu_torch.core import registry
    from paddle_tpu_torch.lowering import LowerCtx

    rule = registry.get_op_def("beam_search").lower
    nbk, k = 320, 30000
    ins = {"pre_ids": [torch.randint(0, 3, (nbk, 1), generator=g,
                                     device="cuda")],
           "pre_scores": [torch.randint(0, 3, (nbk, 1), generator=g,
                                        device="cuda").float() * 0.5],
           "scores": [torch.randint(0, 4, (nbk, k), generator=g,
                                    device="cuda").float() * 0.25]}
    attrs = {"beam_size": 4, "end_id": 1, "is_accumulated": True}
    card = rule(LowerCtx("cuda"), ins, attrs)
    host = rule(LowerCtx("cpu"), {s: [v[0].cpu()] for s, v in ins.items()},
                attrs)
    for slot in card:
        assert torch.equal(card[slot][0].cpu(), host[slot][0]), slot


@pytest.mark.cuda
def test_seq2seq_step_on_the_card_matches_the_cpu():
    """A small seq2seq (vocab 500, emb 32, hidden 64, length 8, batch 8):
    two Adam steps on the card from the CPU's initial weights give the
    CPU's losses within float32 rtol 1e-5, and beam-search decoding then
    gives the CPU's ids."""
    _cuda()
    import numpy as np

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import seq2seq

    with fluid.unique_name.guard():
        net = seq2seq.build_seq2seq_train(500, 500, 32, 64, 8, 8, 8)
    with fluid.unique_name.guard():
        infer = seq2seq.build_seq2seq_infer(500, 500, 32, 64, 8, 8, 4, 8)
    cpu = fluid.Executor(fluid.CPUPlace())
    scope0 = fluid.Scope()
    cpu.run(net["startup"], scope=scope0)
    rng = np.random.RandomState(0)
    feed = {k: rng.randint(0, 500, (8, 8)).astype(np.int64)
            for k in net["feeds"]}
    out = {}
    for tag, exe in (("cpu", cpu), ("cuda", fluid.Executor())):
        scope = fluid.Scope()
        for n, t in scope0.vars.items():
            scope.set_var(n, t.clone())
        losses = [float(exe.run(net["main"], feed=feed,
                                fetch_list=[net["loss"]],
                                scope=scope)[0].reshape(-1)[0])
                  for _ in range(2)]
        ids = exe.run(infer["main"], feed={"src_ids": feed["src_ids"]},
                      fetch_list=infer["fetches"][:1], scope=scope)[0]
        out[tag] = (losses, ids)
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], rtol=1e-5)
    assert out["cuda"][1].shape == (9, 32)
    np.testing.assert_array_equal(out["cuda"][1], out["cpu"][1])


# the LoD op types (ops/sequence_ops.py, the sequence tail of
# ops/misc2.py, ops/rnn_ops.py, ops/structured.py) at the CPU tests' small
# size: lengths 0, 1, full and part, hidden 8
def _lod_cases():
    import numpy as np

    rng = np.random.RandomState(15)

    def f(*shape, scale=1.0):
        return (rng.randn(*shape) * scale).astype(np.float32)

    def i(hi, *shape):
        return rng.randint(0, hi, shape).astype(np.int64)

    B, T, D, H = 4, 6, 3, 8
    ln = np.array([0, 1, 6, 3], np.int32)
    seq = {"X": f(B, T, D), "SeqLen": ln}
    ties = rng.randint(-2, 3, (B, T, D)).astype(np.float32)
    crf = {"Emission": f(B, T, 5), "Transition": f(7, 5, scale=0.3),
           "Length": ln}
    # planted ties: integer emissions, a zero transition
    crf_ties = {"Emission": rng.randint(0, 2, (B, T, 5)).astype(np.float32),
                "Transition": np.zeros((7, 5), np.float32), "Length": ln}
    tags = np.array([[0, 1, 4, 2, 3, 3], [2, 3, 1, 4, 0, 0],
                     [4, 4, 4, 4, 4, 4], [0, 1, 1, 2, 3, 4]], np.int64)
    n_w = 4 * H * D + 4 * H * H + 8 * H + 4 * H * H * 2 + 8 * H
    cases = {}
    for p in ("SUM", "AVERAGE", "SQRT", "MAX", "MIN", "LAST", "FIRST"):
        cases[f"sequence_pool_{p}"] = ("sequence_pool", seq,
                                       {"pooltype": p, "pad_value": 0.5})
    for p in ("MAX", "MIN"):
        cases[f"sequence_pool_{p}_ties"] = (
            "sequence_pool", {"X": ties, "SeqLen": ln}, {"pooltype": p})
    cases.update({
        "sequence_softmax": ("sequence_softmax",
                             {"X": f(B, T, scale=3.0), "SeqLen": ln}, {}),
        "sequence_reverse": ("sequence_reverse", seq, {}),
        "sequence_expand": ("sequence_expand", {"X": f(B, D),
                                                "Y": f(B, T, 2),
                                                "SeqLen": ln}, {}),
        "sequence_concat": ("sequence_concat",
                            {"X": [f(B, 5, D), f(B, 4, D)],
                             "SeqLen": [np.array([0, 5, 2, 1], np.int32),
                                        np.array([3, 0, 4, 1], np.int32)]},
                            {}),
        "sequence_pad": ("sequence_pad", dict(seq, PadValue=np.float32([.5])),
                         {"padded_length": 9}),
        "sequence_unpad": ("sequence_unpad", {"X": f(B, T, D),
                                              "Length": ln.astype(np.int64)},
                           {}),
        "sequence_slice": ("sequence_slice",
                           dict(seq, Offset=np.array([[0], [0], [2], [1]]),
                                Length=np.array([[0], [1], [3], [2]])), {}),
        "sequence_erase": ("sequence_erase", {"X": i(6, B, T), "SeqLen": ln},
                           {"tokens": [2, 5]}),
        "sequence_enumerate": ("sequence_enumerate",
                               {"X": i(9, B, T), "SeqLen": ln},
                               {"win_size": 3, "pad_value": 7}),
        "sequence_conv": ("sequence_conv", dict(seq, Filter=f(3 * D, 5)),
                          {"contextLength": 3, "contextStart": -1}),
        "sequence_mask": ("sequence_mask", {"X": ln},
                          {"maxlen": 7, "out_dtype": "float32"}),
        "sequence_reshape": ("sequence_reshape",
                             {"X": f(B, T, 4), "SeqLen": ln}, {"new_dim": 2}),
        "sequence_expand_as": ("sequence_expand_as",
                               {"X": f(B, D), "Y": f(B, T, 2), "SeqLen": ln},
                               {}),
        "sequence_scatter": ("sequence_scatter",
                             {"X": f(B, 10), "Ids": i(12, B, T),
                              "Updates": f(B, T), "SeqLen": ln}, {}),
        "lstm": ("lstm", {"Input": f(B, T, 4 * H, scale=0.5),
                          "Weight": f(H, 4 * H, scale=0.3),
                          "Bias": f(1, 7 * H, scale=0.1), "SeqLen": ln},
                 {"use_peepholes": True}),
        "lstm_reverse": ("lstm", {"Input": f(B, T, 4 * H, scale=0.5),
                                  "Weight": f(H, 4 * H, scale=0.3),
                                  "Bias": f(1, 4 * H, scale=0.1),
                                  "H0": f(B, H), "C0": f(B, H),
                                  "SeqLen": ln},
                         {"use_peepholes": False, "is_reverse": True}),
        "lstmp": ("lstmp", {"Input": f(B, T, 4 * H, scale=0.5),
                            "Weight": f(3, 4 * H, scale=0.3),
                            "ProjWeight": f(H, 3, scale=0.3),
                            "Bias": f(1, 7 * H, scale=0.1), "SeqLen": ln},
                  {"cell_clip": 0.8, "proj_clip": 0.5}),
        "gru": ("gru", {"Input": f(B, T, 3 * H, scale=0.5),
                        "Weight": f(H, 3 * H, scale=0.3),
                        "Bias": f(1, 3 * H, scale=0.1), "H0": f(B, H),
                        "SeqLen": ln}, {}),
        "gru_reverse_origin": ("gru", {"Input": f(B, T, 3 * H, scale=0.5),
                                       "Weight": f(H, 3 * H, scale=0.3),
                                       "SeqLen": ln},
                               {"is_reverse": True, "origin_mode": True}),
        "gru_unit": ("gru_unit", {"Input": f(B, 3 * H, scale=0.5),
                                  "HiddenPrev": f(B, H),
                                  "Weight": f(H, 3 * H, scale=0.3),
                                  "Bias": f(1, 3 * H, scale=0.1)}, {}),
        "cudnn_lstm": ("cudnn_lstm", {"Input": f(B, T, D),
                                      "W": f(n_w, scale=0.3),
                                      "InitH": f(2, B, H), "InitC": f(2, B, H),
                                      "SeqLen": ln},
                       {"hidden_size": H, "num_layers": 2}),
        "warpctc": ("warpctc", {"Logits": f(B, 7, 5),
                                "Label": np.array([[2, 2, 3], [1, 4, 0],
                                                   [3, 0, 0], [4, 1, 1]]),
                                "LogitsLength": np.array([7, 5, 7, 2]),
                                "LabelLength": np.array([3, 2, 0, 1])},
                    {"norm_by_times": True}),
        "linear_chain_crf": ("linear_chain_crf",
                             dict(crf, Label=i(5, B, T, 1)), {}),
        "crf_decoding": ("crf_decoding", crf, {}),
        "crf_decoding_ties": ("crf_decoding", crf_ties, {}),
        "nce": ("nce", {"Input": f(B, 6), "Label": i(12, B, 1),
                        "Weight": f(12, 6, scale=0.5), "Bias": f(12)},
                {"num_total_classes": 12, "num_neg_samples": 3,
                 "seed": 7}),
        "hierarchical_sigmoid": ("hierarchical_sigmoid",
                                 {"X": f(B, 6), "W": f(6, 6, scale=0.5),
                                  "Label": np.array([[0], [3], [6], [5]]),
                                  "Bias": f(6, scale=0.1)},
                                 {"num_classes": 7}),
        "edit_distance": ("edit_distance",
                          {"Hyps": i(5, B, T), "Refs": i(5, B, 5),
                           "HypsLength": np.array([0, 1, 6, 4]),
                           "RefsLength": np.array([3, 0, 5, 4])},
                          {"normalized": True}),
        "ctc_align": ("ctc_align", {"Input": i(4, B, 8),
                                    "InputLength": np.array([8, 5, 3, 0])},
                      {"blank": 0}),
        "chunk_eval": ("chunk_eval", {"Inference": tags,
                                      "Label": np.roll(tags, 1, axis=1),
                                      "SeqLength": ln},
                       {"num_chunk_types": 2, "chunk_scheme": "IOB"}),
    })
    return cases


LOD_CASES = sorted(_lod_cases())


def _check_nce_formula(arrays, attrs, outs):
    """nce's Cost and SampleLogits against the reference's formula
    (nce_op.h:237-245, the uniform sampler) in float64 on the sampled
    labels the op returned."""
    ids = outs["SampleLabels0"]
    x = torch.from_numpy(arrays["Input"]).double()
    w = torch.from_numpy(arrays["Weight"]).double()
    s = torch.einsum("bd,bsd->bs", x, w[ids]) + torch.from_numpy(
        arrays["Bias"]).double()[ids]
    o = torch.sigmoid(s)
    bq = attrs["num_neg_samples"] / attrs["num_total_classes"]
    cost = -torch.log(o[:, 0] / (o[:, 0] + bq)) - torch.log(
        bq / (o[:, 1:] + bq)).sum(1)
    torch.testing.assert_close(outs["SampleLogits0"].double(), o,
                               rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(outs["Cost0"].double().reshape(-1), cost,
                               rtol=1e-5, atol=1e-5)
    assert ((ids >= 0) & (ids < attrs["num_total_classes"])).all()


def _lod_ins(arrays, device):
    """{slot: [tensor]} on ``device``."""
    import numpy as np

    ins = {}
    for slot, a in arrays.items():
        vals = a if isinstance(a, list) else [a]
        ins[slot] = [torch.from_numpy(np.ascontiguousarray(v)).to(device)
                     for v in vals]
    return ins


@pytest.mark.cuda
@pytest.mark.parametrize("case", LOD_CASES)
def test_lod_op_on_the_card_matches_the_cpu(case):
    """Each LoD op type's rule on the card against the same rule on the
    CPU (float32 rtol 1e-5, atol 1e-6; ints exactly), its forward run
    under ``torch.cuda.set_sync_debug_mode("error")`` (no host sync:
    the lengths never leave the card), and the gradients of its float
    inputs (autograd over the rule, as the generic grad runs it) within
    rtol 1e-4, atol 1e-5."""
    _cuda()
    from paddle_tpu_torch.core import registry
    from paddle_tpu_torch.lowering import LowerCtx

    op_type, arrays, attrs = _lod_cases()[case]
    opdef = registry.get_op_def(op_type)
    attrs = dict({k: a.default for k, a in opdef.attrs.items()}, **attrs)
    diff = {s.name for s in opdef.inputs if not s.no_grad} \
        if opdef.grad is not None else set()
    out = {}
    for dev in ("cpu", "cuda"):
        ins = _lod_ins(arrays, dev)
        prims = [v for slot in sorted(ins) if slot in diff
                 for v in ins[slot] if v.is_floating_point()]
        for p in prims:
            p.requires_grad_()
        ctx = LowerCtx(dev, seed=1, uid=7)
        if dev == "cuda":
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
        try:
            with torch.enable_grad():
                res = opdef.lower(ctx, ins, attrs)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        flat = [(f"{s}{k}", v) for s in sorted(res)
                for k, v in enumerate(res[s]) if v is not None]
        ys = [v for _, v in flat if v.requires_grad]
        grads = []
        if prims and ys:
            g = torch.Generator().manual_seed(3)
            cts = [torch.randn(y.shape, generator=g).to(dev) for y in ys]
            grads = torch.autograd.grad(ys, prims, cts, allow_unused=True)
        out[dev] = ([(n, v.detach().cpu()) for n, v in flat],
                    [None if gr is None else gr.cpu() for gr in grads])
    (cpu_outs, cpu_grads), (card_outs, card_grads) = out["cpu"], out["cuda"]
    if op_type == "nce":
        # the card's generator draws other negatives than the CPU's from
        # the same seed: hold the card's cost to the formula on its own
        # SampleLabels instead (the CPU tests check the formula there)
        _check_nce_formula(arrays, attrs, dict(card_outs))
        assert all(torch.isfinite(g).all() for g in card_grads)
        return
    for (n, a), (_, b) in zip(card_outs, cpu_outs):
        assert a.dtype == b.dtype and a.shape == b.shape, n
        if a.is_floating_point():
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6, msg=n)
        else:
            assert torch.equal(a, b), n
    assert len(card_grads) == len(cpu_grads)
    for a, b in zip(card_grads, cpu_grads):
        assert (a is None) == (b is None)
        if a is not None:
            assert torch.isfinite(a).all()
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)
    if "ties" in case and op_type == "sequence_pool":
        assert card_grads, case


def _sparse_rules():
    from paddle_tpu_torch.core import registry

    return (registry.get_op_def("lookup_table").grad_lower,
            {t: registry.get_op_def(t).lower
             for t in ("sgd", "momentum", "adam", "adagrad", "sum")})


SPARSE_PAD = 3


def _sparse_inputs(height=50_000, dim=10, batch=512, fields=39):
    """A table, Zipf-like repeated ids (16 hot ids in half the fields, a
    padding id in the first) and an output grad, made on the CPU from a
    seed."""
    g = torch.Generator().manual_seed(11)
    w = torch.randn(height, dim, generator=g)
    hot = torch.randint(0, 16, (batch, fields // 2), generator=g)
    cold = torch.randint(0, height, (batch, fields - fields // 2),
                         generator=g)
    ids = torch.cat([hot, cold], 1)
    ids[:, 0] = SPARSE_PAD
    dout = torch.randn(batch, fields, dim, generator=g)
    return w, ids, dout


def _sparse_grad(w, ids, dout):
    """The sparse grad of a table read twice (the second lookup reads the
    first 5 fields), merged by ``sum``, on the inputs' device."""
    from paddle_tpu_torch.lowering import LowerCtx

    grad_rule, rules = _sparse_rules()
    ctx = LowerCtx(w.device)
    attrs = {"is_sparse": True, "padding_idx": SPARSE_PAD}
    g1 = grad_rule(ctx, {"W": [w], "Ids": [ids], "Out@GRAD": [dout]},
                   attrs)["W@GRAD"][0]
    g2 = grad_rule(ctx, {"W": [w], "Ids": [ids[:, :5]],
                         "Out@GRAD": [dout[:, :5]]}, attrs)["W@GRAD"][0]
    return rules["sum"](ctx, {"X": [g1, g2]}, {})["Out"][0]


def _sparse_state(w):
    """The update rules' state for table ``w``, made on the CPU from a
    seed and moved to ``w``'s device (before any strict region: the copy
    from host memory synchronises)."""
    g = torch.Generator().manual_seed(12)
    state = {k: torch.rand(w.shape, generator=g).to(w.device)
             for k in ("v", "m1", "m2")}
    state.update(lr=torch.full((1,), 0.1, device=w.device),
                 b1p=torch.full((1,), 0.81, device=w.device),
                 b2p=torch.full((1,), 0.998, device=w.device))
    return state


def _sparse_updates(w, grad, state):
    """Every sparse update rule on ``grad`` from ``state``: {name: updated
    tensor}."""
    from paddle_tpu_torch.lowering import LowerCtx

    _, rules = _sparse_rules()
    ctx = LowerCtx(w.device)
    lr, pows = state["lr"], (state["b1p"], state["b2p"])
    out = {"sgd": rules["sgd"](ctx, {"Param": [w], "Grad": [grad],
                                     "LearningRate": [lr]},
                               {})["ParamOut"][0]}
    for nesterov in (False, True):
        res = rules["momentum"](
            ctx, {"Param": [w], "Grad": [grad], "Velocity": [state["v"]],
                  "LearningRate": [lr]},
            {"mu": 0.9, "use_nesterov": nesterov,
             "regularization_method": "l2_decay",
             "regularization_coeff": 0.01})
        out[f"momentum{int(nesterov)}"] = res["ParamOut"][0]
        out[f"momentum{int(nesterov)}_v"] = res["VelocityOut"][0]
    for lazy in (False, True):
        res = rules["adam"](
            ctx, {"Param": [w], "Grad": [grad], "LearningRate": [lr],
                  "Moment1": [state["m1"]], "Moment2": [state["m2"]],
                  "Beta1Pow": [pows[0]], "Beta2Pow": [pows[1]]},
            {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8,
             "lazy_mode": lazy})
        out[f"adam{int(lazy)}"] = res["ParamOut"][0]
        out[f"adam{int(lazy)}_m2"] = res["Moment2Out"][0]
    res = rules["adagrad"](ctx, {"Param": [w], "Grad": [grad],
                                 "Moment": [state["m2"]],
                                 "LearningRate": [lr]}, {"epsilon": 1e-6})
    out["adagrad"] = res["ParamOut"][0]
    return out


def _sparse_step_on_card(strict):
    w, ids, dout = (t.cuda() for t in _sparse_inputs())
    state = _sparse_state(w)
    if strict:
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
    try:
        grad = _sparse_grad(w, ids, dout)
        out = _sparse_updates(w, grad, state)
    finally:
        if strict:
            torch.cuda.set_sync_debug_mode("default")
    return grad, out


@pytest.mark.cuda
def test_sparse_grad_and_updates_make_no_host_sync_and_match_the_cpu():
    """The SelectedRows path on the card (``merge_rows``, the shared
    table's ``sum``, every sparse update rule, lazy Adam's writes) under
    ``torch.cuda.set_sync_debug_mode("error")``: no host sync. The
    merged grad's rows equal the CPU's and each value lies within the f32
    recursive-summation bound of a float64 merge on the CPU, (rows of
    its id - 1) * 2^-24 * the sum of their magnitudes (the card's
    accumulate adds in its own order); the updates from that grad equal
    the same rules' on the CPU from the same grad within f32 rtol 1e-5,
    atol 1e-6."""
    from paddle_tpu_torch.core.selected_rows import SelectedRows

    _cuda()
    grad, card = _sparse_step_on_card(strict=True)
    w, ids, dout = _sparse_inputs()
    ref = _sparse_grad(w.double(), ids, dout.double())
    mag = _sparse_grad(w.double(), ids, dout.double().abs())
    assert torch.equal(grad.rows.cpu(), ref.rows)
    reads = torch.cat([ids.reshape(-1), ids[:, :5].reshape(-1)])
    counts = torch.bincount(reads, minlength=w.shape[0] + 1).double()
    live = ref.rows < w.shape[0]
    n = counts[ref.rows.clamp(max=w.shape[0])][:, None]
    bound = (n - 1).clamp(min=0) * 2.0 ** -24 * mag.values + 1e-7
    err = (grad.values.cpu().double() - ref.values).abs()
    assert (err[live] <= bound[live]).all(), float(err.max())
    assert (grad.values.cpu()[~live] == 0).all()
    cpu = _sparse_updates(w, SelectedRows(grad.rows.cpu(),
                                          grad.values.cpu(), grad.height),
                          _sparse_state(w))
    for name, a in card.items():
        torch.testing.assert_close(a.cpu(), cpu[name], rtol=1e-5, atol=1e-6,
                                   msg=name)


@pytest.mark.cuda
def test_sparse_grad_and_updates_are_bit_identical_from_run_to_run():
    """Two runs of the sparse grad (heavily repeated ids, a padding id)
    and of every sparse update give the same bits on the card: the
    merge sums in a fixed order and every write of a row carries one
    value."""
    _cuda()
    (ga, a), (gb, b) = (_sparse_step_on_card(strict=False)
                        for _ in range(2))
    assert torch.equal(ga.rows, gb.rows) and torch.equal(ga.values,
                                                          gb.values)
    for n in a:
        assert torch.equal(a[n], b[n]), n


# ------------------------------------------------- the misc and image groups
def _mi_cases():
    """One case per op type of ``ops/misc.py`` and ``ops/image.py`` but
    the two random ones, at a small size: (op type, {slot: array or list},
    attrs). Ties are planted where an op takes a maximum."""
    import numpy as np

    rng = np.random.RandomState(17)

    def f(*shape, scale=1.0):
        return (rng.randn(*shape) * scale).astype(np.float32)

    def i(lo, hi, *shape):
        return rng.randint(lo, hi, shape).astype(np.int64)

    def probs(*shape):
        z = np.exp(f(*shape))
        return (z / z.sum(-1, keepdims=True)).astype(np.float32)

    ties = rng.randint(0, 3, (2, 3, 6, 8)).astype(np.float32)
    img = f(2, 3, 6, 8)
    ids = i(-50, 50, 300)
    mask = np.stack([np.arange(12, dtype=np.int32) * 4 % 48] * 6) \
        .reshape(2, 3, 3, 4)
    return {
        "linspace": ("linspace", {"Start": np.array([0.5], np.float32),
                                  "Stop": np.array([3.0], np.float32),
                                  "Num": np.array([7], np.int32)},
                     {}),
        "fill": ("fill", {}, {"value": [1.0, 2.5, -3.0, 4.0],
                              "shape": [2, 2]}),
        "fill_any_like": ("fill_any_like", {"X": img}, {"value": 2.0}),
        "fill_zeros_like2": ("fill_zeros_like2", {"X": img}, {}),
        "size": ("size", {"Input": img}, {}),
        "is_empty": ("is_empty", {"X": img}, {}),
        "one_hot_v2": ("one_hot_v2", {"X": i(-1, 7, 4, 3)}, {"depth": 6}),
        "multiplex": ("multiplex", {"Ids": i(0, 2, 5, 1),
                                    "X": [f(5, 4), f(5, 4)]}, {}),
        "strided_slice": ("strided_slice", {"Input": img},
                          {"axes": [2, 3], "starts": [-1, 1],
                           "ends": [0, 8], "strides": [-2, 3]}),
        "minus": ("minus", {"X": f(3, 4), "Y": f(3, 4)}, {}),
        "l1_norm": ("l1_norm", {"X": f(3, 4)}, {}),
        "norm": ("norm", {"X": f(3, 4, 5)}, {"axis": 1}),
        "squared_l2_distance": ("squared_l2_distance",
                                {"X": f(4, 5), "Y": f(1, 5)}, {}),
        "bilinear_tensor_product": (
            "bilinear_tensor_product", {"X": f(4, 3), "Y": f(4, 5),
                                        "Weight": f(2, 3, 5),
                                        "Bias": f(1, 2)}, {}),
        "fsp": ("fsp", {"X": img, "Y": f(2, 4, 6, 8)}, {}),
        "modified_huber_loss": ("modified_huber_loss",
                                {"X": f(8, 1, scale=2.0),
                                 "Y": i(0, 2, 8, 1).astype(np.float32)},
                                {}),
        "teacher_student_sigmoid_loss": (
            "teacher_student_sigmoid_loss",
            {"X": f(5, 1), "Label": np.array([[-2], [-1], [0.3], [1.5],
                                              [0.9]], np.float32)}, {}),
        "cross_entropy2": ("cross_entropy2",
                           {"X": probs(5, 6), "Label": np.array(
                               [[0], [5], [-100], [2], [3]], np.int64)}, {}),
        "label_smooth": ("label_smooth", {"X": probs(4, 6)},
                         {"epsilon": 0.1}),
        "center_loss": ("center_loss",
                        {"X": f(6, 4), "Label": i(0, 3, 6, 1),
                         "Centers": f(3, 4),
                         "CenterUpdateRate": np.array([0.5], np.float32)},
                        {"cluster_num": 3}),
        "add_position_encoding": ("add_position_encoding",
                                  {"X": f(2, 7, 8)}, {"beta": 0.5}),
        "row_conv": ("row_conv", {"X": f(2, 6, 3), "Filter": f(3, 3)}, {}),
        "conv_shift": ("conv_shift", {"X": f(3, 7), "Y": f(3, 3)}, {}),
        "cvm": ("cvm", {"X": np.abs(f(4, 6)) * 5, "CVM": f(4, 2)}, {}),
        "data_norm": ("data_norm",
                      {"X": f(4, 5), "BatchSize": np.full(5, 1e4, np.float32),
                       "BatchSum": f(5, scale=10.0),
                       "BatchSquareSum": np.abs(f(5)) * 1e4 + 1e3}, {}),
        "hash": ("hash", {"X": i(-2 ** 31, 2 ** 31 - 1, 40, 3)},
                 {"num_hash": 2, "mod_by": 10007}),
        "unique": ("unique", {"X": ids}, {"dtype": "int64"}),
        "unique_with_counts": ("unique_with_counts", {"X": ids}, {}),
        "spectral_norm": ("spectral_norm", {"Weight": f(6, 4, 3),
                                            "U": f(6), "V": f(12)},
                          {"power_iters": 2}),
        "tree_conv": ("tree_conv",
                      {"NodesVector": f(2, 6, 3),
                       "EdgeSet": np.array([[[1, 2], [1, 3], [3, 4], [0, 0]],
                                            [[1, 2], [2, 3], [0, 0],
                                             [0, 0]]], np.int64),
                       "Filter": f(3, 3, 2, 2)}, {"max_depth": 2}),
        "similarity_focus": ("similarity_focus", {"X": ties},
                             {"axis": 1, "indexes": [0, 2]}),
        "pixel_shuffle": ("pixel_shuffle", {"X": f(2, 8, 3, 4)},
                          {"upscale_factor": 2}),
        "affine_channel": ("affine_channel", {"X": img, "Scale": f(3),
                                              "Bias": f(3)}, {}),
        "shuffle_channel": ("shuffle_channel", {"X": f(2, 6, 3, 4)},
                            {"group": 3}),
        "space_to_depth": ("space_to_depth", {"X": img}, {"blocksize": 2}),
        "temporal_shift": ("temporal_shift", {"X": f(6, 8, 3, 3)},
                           {"seg_num": 3, "shift_ratio": 0.125}),
        "crop": ("crop", {"X": img}, {"shape": [1, 2, 4, 5],
                                      "offsets": [1, 0, 2, 3]}),
        "crop_tensor": ("crop_tensor", {"X": img, "Shape": np.array(
            [2, 3, 3, 3], np.int32)}, {"offsets": [0, 0, 1, 4]}),
        "pad_constant_like": ("pad_constant_like",
                              {"X": img, "Y": f(1, 3, 4, 5)},
                              {"pad_value": 0.5}),
        "unfold": ("unfold", {"X": img},
                   {"kernel_sizes": [2, 3], "strides": [2, 1],
                    "paddings": [1, 0, 0, 1], "dilations": [1, 2]}),
        "im2sequence": ("im2sequence", {"X": img},
                        {"kernels": [2, 2], "strides": [2, 2]}),
        "lrn": ("lrn", {"X": f(2, 7, 3, 4)}, {"alpha": 1e-2}),
        "spp": ("spp", {"X": ties}, {"pyramid_height": 3}),
        "max_pool2d_with_index": ("max_pool2d_with_index", {"X": ties},
                                  {"ksize": [3, 3], "strides": [2, 2],
                                   "paddings": [1, 1]}),
        "unpool": ("unpool", {"X": f(2, 3, 3, 4), "Indices": mask}, {}),
        "affine_grid": ("affine_grid", {"Theta": f(2, 2, 3)},
                        {"output_shape": [2, 3, 5, 7]}),
        "grid_sampler": ("grid_sampler", {"X": img,
                                          "Grid": f(2, 4, 5, 2, scale=0.8)},
                         {"padding_mode": "reflection",
                          "align_corners": False}),
        "conv3d": ("conv3d", {"Input": f(2, 3, 4, 5, 6),
                              "Filter": f(4, 3, 3, 3, 3)},
                   {"paddings": [1, 1, 1]}),
        "conv3d_transpose": ("conv3d_transpose",
                             {"Input": f(2, 3, 3, 4, 4),
                              "Filter": f(3, 4, 2, 2, 2)},
                             {"strides": [2, 2, 2]}),
        "pool3d": ("pool3d", {"X": rng.randint(0, 3, (2, 2, 5, 6, 7))
                              .astype(np.float32)},
                   {"ksize": [3, 3, 3], "paddings": [1, 1, 1]}),
        "trilinear_interp": ("trilinear_interp", {"X": f(2, 2, 4, 5, 6)},
                             {"out_d": 2, "out_h": 9, "out_w": 6,
                              "align_corners": False}),
    }


MI_CASES = sorted(_mi_cases())
MI_STRICT = ("unique", "unique_with_counts", "hash")


@contextlib.contextmanager
def _cudnn_at_torch_defaults():
    """cuDNN may use TF32 and algorithms that need not repeat, as torch
    starts (other tests turn TF32 off), restored after."""
    cudnn = torch.backends.cudnn
    was = cudnn.deterministic, cudnn.allow_tf32
    cudnn.deterministic, cudnn.allow_tf32 = False, True
    try:
        yield
    finally:
        cudnn.deterministic, cudnn.allow_tf32 = was


def _mi_rule(op_type, arrays, attrs, dev, strict):
    """The rule on ``dev`` (its forward under
    ``set_sync_debug_mode("error")`` with ``strict``) and the gradients
    of its float inputs: (outputs, grads), on the CPU."""
    from paddle_tpu_torch.core import registry
    from paddle_tpu_torch.lowering import LowerCtx

    opdef = registry.get_op_def(op_type)
    attrs = dict({k: a.default for k, a in opdef.attrs.items()}, **attrs)
    diff = {s.name for s in opdef.inputs if not s.no_grad} \
        if opdef.grad is not None else set()
    ins = _lod_ins(arrays, dev)
    prims = [v for slot in sorted(ins) if slot in diff
             for v in ins[slot] if v.is_floating_point()]
    for p in prims:
        p.requires_grad_()
    strict = strict and dev == "cuda"
    if dev == "cuda":
        torch.cuda.synchronize()
    if strict:
        torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.enable_grad():
            res = opdef.lower(LowerCtx(dev, seed=1, uid=7), ins, attrs)
    finally:
        if strict:
            torch.cuda.set_sync_debug_mode("default")
    flat = [(f"{s}{k}", v) for s in sorted(res)
            for k, v in enumerate(res[s]) if v is not None]
    ys = [v for _, v in flat if v.requires_grad]
    grads = []
    if prims and ys:
        g = torch.Generator().manual_seed(3)
        cts = [torch.randn(y.shape, generator=g).to(dev) for y in ys]
        grads = torch.autograd.grad(ys, prims, cts, allow_unused=True)
    return ([(n, v.detach().cpu()) for n, v in flat],
            [None if gr is None else gr.cpu() for gr in grads])


@pytest.mark.cuda
@pytest.mark.parametrize("case", MI_CASES)
def test_misc_image_op_on_the_card_matches_the_cpu(case):
    """Each op type of the misc and image groups on the card against the
    CPU (float32 rtol 1e-5, atol 1e-6, the 3-D convolutions and the
    products rtol 1e-4; ints exactly), its float inputs' gradients
    within rtol 1e-4, atol 1e-5, and a second card run bit-identical,
    with cuDNN's process-wide settings at torch's defaults (the port's
    convolutions set their own); ``unique``, ``unique_with_counts`` and
    ``hash`` with no host sync."""
    _cuda()
    op_type, arrays, attrs = _mi_cases()[case]
    strict = op_type in MI_STRICT
    cpu_outs, cpu_grads = _mi_rule(op_type, arrays, attrs, "cpu", False)
    with _cudnn_at_torch_defaults():
        card_outs, card_grads = _mi_rule(op_type, arrays, attrs, "cuda",
                                         strict)
        again_outs, again_grads = _mi_rule(op_type, arrays, attrs, "cuda",
                                           strict)
    loose = op_type in ("conv3d", "conv3d_transpose", "fsp", "tree_conv",
                        "bilinear_tensor_product", "spectral_norm")
    for (n, a), (_, b), (_, c) in zip(card_outs, cpu_outs, again_outs):
        assert a.dtype == b.dtype and a.shape == b.shape, n
        assert torch.equal(a, c), n
        if a.is_floating_point():
            torch.testing.assert_close(a, b, rtol=1e-4 if loose else 1e-5,
                                       atol=1e-6 if not loose else 1e-5,
                                       msg=n)
        else:
            assert torch.equal(a, b), n
    assert len(card_grads) == len(cpu_grads)
    for a, b, c in zip(card_grads, cpu_grads, again_grads):
        assert (a is None) == (b is None)
        if a is not None:
            assert torch.equal(a, c)
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)


CONV_RULES = {
    "conv2d": ("conv2d", (8, 64, 28, 28), (128, 64, 3, 3),
               {"strides": [1, 1], "paddings": [1, 1]}),
    "conv2d_transpose": ("conv2d_transpose", (8, 64, 14, 14),
                         (64, 32, 4, 4), {"strides": [2, 2],
                                          "paddings": [1, 1]}),
    "conv3d": ("conv3d", (4, 32, 8, 28, 28), (64, 32, 3, 3, 3),
               {"strides": [1, 1, 1], "paddings": [1, 1, 1]}),
    "conv3d_transpose": ("conv3d_transpose", (2, 64, 8, 8, 8),
                         (64, 32, 2, 2, 2), {"strides": [2, 2, 2]}),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CONV_RULES))
def test_convolutions_keep_float32_and_repeat_whatever_cudnn_is_set_to(
        case):
    """With cuDNN's process-wide settings at torch's defaults (TF32 on
    for convolutions, algorithms that need not repeat allowed), each
    convolution rule's output and input and filter gradients on the card
    are within 2e-5 normwise of the CPU's (TF32's 10-bit mantissa would
    miss by about 1e-3), a second run is bit-identical, and the settings
    are as they were afterwards."""
    _cuda()
    op_type, xs, ws, attrs = CONV_RULES[case]
    g = torch.Generator().manual_seed(5)
    arrays = {"Input": torch.randn(xs, generator=g),
              "Filter": torch.randn(ws, generator=g) / math.sqrt(
                  math.prod(ws[1:]))}
    cpu_outs, cpu_grads = _mi_rule(op_type, arrays, attrs, "cpu", False)
    with _cudnn_at_torch_defaults():
        outs, grads = _mi_rule(op_type, arrays, attrs, "cuda", False)
        again_outs, again_grads = _mi_rule(op_type, arrays, attrs, "cuda",
                                           False)
        assert (torch.backends.cudnn.deterministic,
                torch.backends.cudnn.allow_tf32) == (False, True)
    card = [v for _, v in outs] + list(grads)
    again = [v for _, v in again_outs] + list(again_grads)
    cpu = [v for _, v in cpu_outs] + list(cpu_grads)
    assert len(card) == len(cpu) == 3
    for a, b, c in zip(card, again, cpu):
        assert torch.equal(a, b)
        assert float((a - c).abs().max()) <= 2e-5 * float(c.abs().max())


def test_misc_image_cases_cover_every_op_type_of_the_groups():
    from paddle_tpu_torch.ops import image, misc  # noqa: F401
    from paddle_tpu_torch.core import registry

    mods = ("paddle_tpu_torch.ops.misc", "paddle_tpu_torch.ops.image")
    group = {t for t in registry.all_ops()
             if registry.get_op_def(t).lower.__module__ in mods}
    assert len(group) == 53
    assert {c[0] for c in _mi_cases().values()} == group - {
        "random_crop", "sampling_id"}


@pytest.mark.cuda
def test_random_crop_and_sampling_id_on_the_card():
    """random_crop draws its offsets on the host: the card's crop is the
    CPU's. sampling_id repeats under a seed and never draws an id of
    probability 0."""
    _cuda()
    from paddle_tpu_torch.core import registry
    from paddle_tpu_torch.lowering import LowerCtx

    x = torch.randn(4, 3, 12, 10)
    crop = registry.get_op_def("random_crop").lower
    got = {dev: crop(LowerCtx(dev, seed=5, uid=2), {"X": [x.to(dev)]},
                     {"shape": [3, 8, 7], "startup_seed": 0})["Out"][0]
           for dev in ("cpu", "cuda")}
    assert torch.equal(got["cuda"].cpu(), got["cpu"])
    p = torch.zeros(64, 50)
    p[:, [3, 17, 40]] = torch.tensor([0.5, 0.3, 0.2])
    sample = registry.get_op_def("sampling_id").lower
    draws = [sample(LowerCtx("cuda", seed=1, uid=4), {"X": [p.cuda()]},
                    {"seed": 9})["Out"][0] for _ in range(2)]
    assert torch.equal(draws[0], draws[1])
    assert set(draws[0].cpu().tolist()) <= {3, 17, 40}


# ------------------------------------------------------------ detection
def _det_rule(op_type, ins, attrs, dev, uid=3):
    from paddle_tpu_torch.core import registry
    from paddle_tpu_torch.lowering import LowerCtx

    opdef = registry.get_op_def(op_type)
    attrs = dict({k: a.default for k, a in opdef.attrs.items()}, **attrs)
    ins = {k: [v.to(dev) for v in vs] for k, vs in ins.items()}
    return opdef.lower(LowerCtx(dev, seed=1, uid=uid), ins, attrs)


@contextlib.contextmanager
def _syncs_counted():
    """Host syncs on the card in the block, counted from
    ``set_sync_debug_mode("warn")``'s warnings (a copy of an input to the
    card is one: make them before)."""
    import warnings
    torch.cuda.synchronize()
    seen = []
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield seen
        finally:
            torch.cuda.set_sync_debug_mode("default")
    seen.append(sum("called a synchronizing CUDA operation" in str(w.message)
                    for w in caught))


def _yolo_image(seed=0, boxes=22743, classes=80):
    """One YOLOv3-608 image's BBoxes and Scores on exact data: integer
    pixels, chains of 16 boxes each overlapping the next, distinct dyadic
    scores, 0.4% of the class scores above 0.005."""
    g = torch.Generator().manual_seed(seed)
    xy = torch.randint(0, 450, (boxes, 2), generator=g)
    wh = torch.randint(8, 150, (boxes, 2), generator=g)
    b = torch.cat([xy, (xy + wh).clamp(max=607)], 1).float()
    for c in range(30):                         # 30 chains of 16
        x0, y0 = 20 * c % 400, 13 * c % 450
        t = torch.arange(16)
        b[c * 16:(c + 1) * 16] = torch.stack(
            [x0 + 12 * t, torch.full_like(t, y0), x0 + 40 + 12 * t,
             torch.full_like(t, y0 + 40)], 1).float()
    k = torch.randperm((1 << 23) - 41945, generator=g)[:boxes * classes] \
        + 41945
    s = torch.randint(0, 41944, (classes, boxes), generator=g).double()
    live = torch.rand((classes, boxes), generator=g) < 0.004
    live[:, :480] = True
    s[live] = k[:int(live.sum())].double()
    return b[None], (s / (1 << 23)).float()[None]


@pytest.mark.cuda
def test_nms_on_exact_data_equals_the_cpu_at_yolov3_width():
    """multiclass_nms over one YOLOv3-608 image (22743 boxes, 80
    classes) on the card equals the CPU's bit for bit, and its host
    syncs are exactly the design's: the candidate count and the
    fixed-point checks (``nms_sync_count``)."""
    _cuda()
    from paddle_tpu_torch.ops import detection as D

    b, s = _yolo_image()
    attrs = {"background_label": -1, "score_threshold": 0.005,
             "nms_top_k": 400, "nms_threshold": 0.45, "keep_top_k": 100,
             "normalized": False}
    cpu = _det_rule("multiclass_nms", {"BBoxes": [b], "Scores": [s]},
                    attrs, "cpu")["Out"][0]
    b, s = b.cuda(), s.cuda()
    n0 = D.nms_sync_count()
    with _syncs_counted() as seen:
        card = _det_rule("multiclass_nms", {"BBoxes": [b], "Scores": [s]},
                         attrs, "cuda")["Out"][0]
    assert seen[0] == D.nms_sync_count() - n0 >= 2
    assert torch.equal(card.cpu(), cpu)
    assert int((cpu[0, :, 0] >= 0).sum()) == 100


@pytest.mark.cuda
def test_proposals_sync_only_for_the_fixed_point_checks():
    _cuda()
    from paddle_tpu_torch.ops import detection as D

    g = torch.Generator().manual_seed(1)
    h, w = 50, 84
    an = _det_rule("anchor_generator",
                   {"Input": [torch.zeros(1, 8, h, w)]},
                   {"anchor_sizes": [128.0], "stride": [16.0, 16.0],
                    "variances": [1.0] * 4}, "cpu")
    ins = {"Scores": [torch.randperm(3 * h * w, generator=g)
                      .float().reshape(1, 3, h, w) / 16384],
           "BboxDeltas": [torch.round(torch.randn(1, 12, h, w, generator=g)
                                      * 2) / 16 * torch.tensor(
               [1.0, 1, 0, 0] * 3)[None, :, None, None]],
           "ImInfo": [torch.tensor([[800.0, 1344.0, 1.0]])],
           "Anchors": an["Anchors"], "Variances": an["Variances"]}
    attrs = {"pre_nms_topN": 1000, "post_nms_topN": 1000,
             "nms_thresh": 0.7, "min_size": 0.0}
    cpu = _det_rule("generate_proposals", ins, attrs, "cpu")
    ins = {k: [v.cuda() for v in vs] for k, vs in ins.items()}
    n0 = D.nms_sync_count()
    with _syncs_counted() as seen:
        card = _det_rule("generate_proposals", ins, attrs, "cuda")
    assert seen[0] == D.nms_sync_count() - n0 >= 1
    for k in cpu:
        assert torch.equal(card[k][0].cpu(), cpu[k][0]), k


def _det_grad_cases():
    g = torch.Generator().manual_seed(2)

    def f(*shape, scale=1.0):
        return torch.randn(shape, generator=g) * scale

    rois = torch.tensor([[4.0, 6.0, 60.0, 50.0], [0.0, 0.0, 120.0, 90.0],
                         [30.5, 20.25, 44.0, 80.0], [70.0, 10.0, 130.0,
                                                     60.0]])
    bidx = torch.tensor([0, 1, 1, 0], dtype=torch.int32)
    return {
        "roi_align": ("roi_align", {"X": f(2, 16, 24, 34), "ROIs": rois,
                                    "RoisBatchIdx": bidx},
                      {"spatial_scale": 0.25, "pooled_height": 7,
                       "pooled_width": 7, "sampling_ratio": 2}),
        "deformable_conv": ("deformable_conv",
                            {"Input": f(2, 16, 12, 14),
                             "Offset": f(2, 36, 12, 14, scale=2.0),
                             "Mask": torch.rand((2, 18, 12, 14),
                                                generator=g),
                             "Filter": f(16, 8, 3, 3)},
                            {"paddings": [1, 1], "groups": 2,
                             "deformable_groups": 2}),
        "prroi_pool": ("prroi_pool", {"X": f(2, 16, 24, 34), "ROIs": rois,
                                      "BatchRoINums": torch.tensor(
                                          [2, 2], dtype=torch.int32)},
                       {"spatial_scale": 0.25, "pooled_height": 7,
                        "pooled_width": 7}),
        "deformable_psroi_pooling": (
            "deformable_psroi_pooling",
            {"Input": f(2, 4 * 49, 24, 34), "ROIs": rois,
             "Trans": f(4, 2, 7, 7, scale=0.5), "RoisBatchIdx": bidx},
            {"spatial_scale": 0.25, "output_dim": 4, "group_size": [7, 7],
             "pooled_height": 7, "pooled_width": 7, "part_size": [7, 7],
             "sample_per_part": 4, "trans_std": 0.1}),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(_det_grad_cases()))
def test_gradients_through_gathers_repeat_bit_for_bit(case):
    """The gathers' gradients accumulate through ``index_put_`` in a fixed
    order on the card: two runs are bit-identical, and both are within
    rtol 1e-4, atol 1e-5 of the CPU's."""
    _cuda()
    op_type, arrays, attrs = _det_grad_cases()[case]
    runs = []
    for dev in ("cuda", "cuda", "cpu"):
        ins = {k: [v.to(dev)] for k, v in arrays.items()}
        prims = [v[0].requires_grad_() for k, v in ins.items()
                 if v[0].is_floating_point() and k not in ("ROIs",)]
        with torch.enable_grad():
            res = _det_rule(op_type, ins, attrs, dev)
            y = next(iter(res.values()))[0]
            ct = torch.randn(y.shape, generator=torch.Generator()
                             .manual_seed(4)).to(dev)
            grads = torch.autograd.grad([y], prims, [ct])
        runs.append([y.detach().cpu()] + [gr.cpu() for gr in grads])
    for a, b, c in zip(*runs):
        assert torch.equal(a, b)
        torch.testing.assert_close(a, c, rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
def test_py_func_round_trips_through_the_host_with_one_sync_an_input():
    _cuda()
    import numpy as np
    from paddle_tpu_torch.ops.misc2 import register_py_func

    fid = register_py_func(lambda a, b: (a * 2 + b, np.array(
        [a.shape[0]], np.int64)))
    a = torch.randn(5, 3, device="cuda")
    b = torch.randn(5, 3, device="cuda")
    with _syncs_counted() as seen:
        res = _det_rule("py_func", {"X": [a, b]},
                        {"func_id": fid, "out_shapes": [[5, 3], [1]],
                         "out_dtypes": ["float32", "int64"]}, "cuda")
    assert seen[0] == 2
    out, n = res["Out"]
    assert out.is_cuda and n.is_cuda and n.dtype == torch.int64
    assert torch.equal(out, a * 2 + b) and n.tolist() == [5]


# -- the division audit: each site on the card equals the CPU exactly -------

def _division_rule(op_type, ins, attrs, dev):
    from paddle_tpu_torch.core import registry
    from paddle_tpu_torch.lowering import LowerCtx

    opdef = registry.get_op_def(op_type)
    attrs = dict({k: a.default for k, a in opdef.attrs.items()}, **attrs)
    ins = {k: [v.to(dev) for v in vs] for k, vs in ins.items()}
    return {k: [v.cpu() for v in vs]
            for k, vs in opdef.lower(LowerCtx(dev, seed=1, uid=1), ins,
                                     attrs).items()}


def _division_cases():
    g = torch.Generator().manual_seed(0)
    ps = torch.randint(0, 64, (2, 18, 40, 52), generator=g).float()
    rois = torch.tensor([[0, 0, 8, 5], [3, 2, 11, 10], [6, 3, 14, 11],
                         [1.3, 2.7, 37.1, 29.9], [0.5, 0.5, 50.2, 38.6],
                         [7, 9, 13, 24]])
    return {
        "nearest_resize": ("interpolate_nearest", {"X": [
            torch.randn(2, 3, 76, 76, generator=g)]},
            {"out_h": 152, "out_w": 190}),
        "nearest_shrink": ("interpolate_nearest", {"X": [
            torch.randn(1, 2, 97, 250, generator=g)]},
            {"out_h": 25, "out_w": 99}),
        "trilinear_corners": ("trilinear_interp", {"X": [
            torch.randn(1, 2, 17, 23, 29, generator=g)]},
            {"out_d": 33, "out_h": 7, "out_w": 57, "align_corners": True}),
        "psroi_pool": ("psroi_pool", {
            "X": [ps], "ROIs": [rois],
            "RoisBatchIdx": [torch.tensor([0, 1, 1, 0, 1, 0])]},
            {"output_channels": 2, "spatial_scale": 1.0,
             "pooled_height": 3, "pooled_width": 3}),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(_division_cases()))
def test_division_audit_op_on_the_card_equals_the_cpu(case):
    _cuda()
    op_type, ins, attrs = _division_cases()[case]
    card = _division_rule(op_type, ins, attrs, "cuda")
    cpu = _division_rule(op_type, ins, attrs, "cpu")
    for k in cpu:
        for a, b in zip(card[k], cpu[k]):
            assert torch.equal(a, b), (case, k)


@pytest.mark.cuda
def test_division_audit_nearest_index_and_linspace_equal_the_cpu():
    """Every (m, n) up to 160 and integer linspaces over a sweep of
    bounds and counts: the card's indices and values equal the CPU's."""
    _cuda()
    from paddle_tpu_torch.ops.misc import linspace_f32
    from paddle_tpu_torch.ops.nn import _nearest_index

    bad = []
    for m in range(1, 161):
        for n in range(1, 161):
            if not torch.equal(_nearest_index(m, n, "cuda").cpu(),
                               _nearest_index(m, n, "cpu")):
                bad.append((m, n))
    assert not bad, bad[:10]
    for start in (-37, -5, 0, 1, 3, 11):
        for stop in (0, 7, 50, 99, 1000, 4097):
            for num in (2, 3, 5, 7, 11, 13, 49, 50, 97, 129):
                for dt in (torch.int64, torch.float32):
                    a = linspace_f32(start, stop, num, "cuda", dt).cpu()
                    b = linspace_f32(start, stop, num, "cpu", dt)
                    if not torch.equal(a, b):
                        bad.append((start, stop, num, dt))
    assert not bad, bad[:10]


# -- DataLoader staging on the card ----------------------------------------

def _loader_batches(n=6, rows=64, seed=0):
    import numpy as np

    rng = np.random.RandomState(seed)
    return [(rng.rand(rows, 3, 32, 32).astype(np.float32),
             rng.randint(0, 10, (rows, 1)).astype(np.int64))
            for _ in range(n)]


def _card_loader(batches, capacity=2):
    import paddle_tpu_torch as tf

    loader = tf.DataLoader.from_generator(feed_list=["img", "label"],
                                          capacity=capacity)
    loader.set_batch_generator(lambda: iter(batches),
                               places=tf.CUDAPlace(0))
    return loader


@pytest.mark.cuda
def test_staged_batches_equal_the_host_arrays_and_skip_the_copy():
    _cuda()
    import paddle_tpu_torch as tf
    from paddle_tpu_torch.executor import _feed_host_bytes

    batches = _loader_batches()
    main, startup = tf.Program(), tf.Program()
    with tf.program_guard(main, startup):
        img = tf.layers.data("img", shape=[3, 32, 32], dtype="float32")
        tf.layers.data("label", shape=[1], dtype="int64")
        s = tf.layers.reduce_sum(img)
    exe = tf.Executor(tf.CUDAPlace(0))
    seen = 0
    for (want_img, want_lbl), b in zip(batches, _card_loader(batches)):
        assert b["img"].is_cuda and b["label"].dtype == torch.int64
        assert torch.equal(b["img"].cpu(), torch.from_numpy(want_img))
        assert torch.equal(b["label"].cpu(), torch.from_numpy(want_lbl))
        assert _feed_host_bytes(b["img"]) == 0
        fed = exe._feed_tensors(main, b)
        assert fed["img"] is b["img"] and fed["label"] is b["label"]
        (got,) = exe.run(main, feed=b, fetch_list=[s])
        assert abs(float(got) - float(want_img.sum(dtype="float64"))) \
            < 1e-2 * abs(float(want_img.sum()))
        seen += 1
    assert seen == len(batches)
    # a caller's tensor on the card is still copied
    t = torch.zeros(4, 3, 32, 32, device="cuda")
    assert exe._feed_tensors(main, {"img": t})["img"] is not t


@pytest.mark.cuda
def test_staging_copies_run_from_pinned_memory_on_a_side_stream(tmp_path):
    """The host-to-device copies of the staged batches are pinned copies
    on a stream other than the one the consumer's kernels run on."""
    import json

    _cuda()
    from torch.profiler import ProfilerActivity, profile

    batches = _loader_batches(n=4)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        outs = [torch.mm(b["img"].reshape(64, -1),
                         b["img"].reshape(64, -1).t())
                for b in _card_loader(batches)]
        torch.cuda.synchronize()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    copies = [e for e in events if e.get("cat") == "gpu_memcpy"
              and "HtoD" in e.get("name", "")]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    assert len(outs) == 4 and copies and kernels
    assert all("Pinned" in e["name"] for e in copies), \
        {e["name"] for e in copies}
    copy_streams = {e["args"]["stream"] for e in copies}
    kernel_streams = {e["args"]["stream"] for e in kernels}
    assert not copy_streams & kernel_streams, (copy_streams, kernel_streams)


@pytest.mark.cuda
def test_a_freed_batch_is_not_overwritten_while_the_step_reads_it():
    """A batch handed out, read by a slow kernel on the consumer's stream
    and dropped before the read has run, while the next batch is staged
    on the loader's side stream: ``record_stream`` keeps the caching
    allocator from giving the dropped batch's memory to that copy before
    the read. Driven through the loader's own staging (``_CudaStager``)
    and hand-out (``_hand_out``) on the test's thread, with the pinned
    ring and the earlier blocks allocated first and the two kernels
    launched once before: a pinned or device allocation, or a kernel's
    first launch (its module loaded lazily), during the read would wait
    for the card and hide the race."""
    import numpy as np
    from paddle_tpu_torch.reader import _CudaStager, _hand_out

    _cuda()
    dev = torch.device("cuda", 0)
    rng = np.random.RandomState(0)
    arrays = [rng.rand(64, 3, 32, 32).astype(np.float32) for _ in range(4)]
    stager = _CudaStager(dev, 2)
    keep = [_hand_out(stager.stage({"x": a}), dev) for a in arrays[:2]]
    first = _hand_out(stager.stage({"x": arrays[2]}), dev)
    torch.cuda._sleep(1000)
    assert torch.equal((first["x"] * 1.0).cpu(), torch.from_numpy(arrays[2]))
    torch.cuda.synchronize()
    x = first["x"]
    torch.cuda._sleep(2_000_000_000)          # about a second on the card
    held = x * 1.0                            # reads the batch after it
    del first, x
    nxt = _hand_out(stager.stage({"x": arrays[3]}), dev)
    torch.cuda.synchronize()
    assert torch.equal(held.cpu(), torch.from_numpy(arrays[2]))
    assert torch.equal(nxt["x"].cpu(), torch.from_numpy(arrays[3]))
    for a, b in zip(arrays, keep):
        assert torch.equal(b["x"].cpu(), torch.from_numpy(a))


# ------------------------------------------------- dygraph, export, quant
def _dy_feed(vocab, B, S, seed=0):
    import numpy as np

    rng = np.random.RandomState(seed)
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


@pytest.mark.cuda
def test_dygraph_embedding_grad_repeats_bit_for_bit_through_its_rule():
    """An eager embedding gradient over many repeated ids: through
    ``lookup_table``'s own grad rule (a sum in a fixed order), so two
    backward passes from the same state are bit-identical on the card."""
    import numpy as np

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import dygraph
    from paddle_tpu_torch.core import registry

    _cuda()
    opdef = registry.get_op_def("lookup_table")
    calls, real = [], opdef.grad_lower

    def spy(ctx, ins, attrs):
        calls.append(1)
        return real(ctx, ins, attrs)

    opdef.grad_lower = spy
    try:
        rng = np.random.RandomState(0)
        ids = rng.randint(0, 64, (32, 128)).astype(np.int64)  # many repeats
        cot = rng.randn(32, 128, 768).astype(np.float32)
        grads = []
        with dygraph.guard(fluid.CUDAPlace(0)):
            dygraph.seed_parameters(0)
            emb = dygraph.Embedding([30522, 768])
            for _ in range(2):
                e = emb(dygraph.to_variable(ids))
                loss = dygraph.ops.reduce_sum(dygraph.ops.elementwise_mul(
                    e, dygraph.to_variable(cot)))
                loss.backward()
                grads.append(emb.weight._grad.clone())
                emb.clear_gradients()
    finally:
        opdef.grad_lower = real
    assert len(calls) == 2
    assert grads[0].is_cuda and torch.equal(grads[0], grads[1])


@pytest.mark.cuda
def test_dygraph_bert_step_launches_each_flash_kernel_once_a_layer():
    """A dygraph BERT step (``tools/torch_dygraph_bert.py``, 2 layers):
    K1, K3 and K4 once a layer each; the eager backward reruns no
    forward."""
    import dataclasses
    import sys

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import dygraph
    from paddle_tpu_torch.models.bert import BertConfig

    sys.path.insert(0, str(__import__("pathlib").Path(__file__).parents[1]))
    from tools.torch_dygraph_bert import DygraphBert, to_feed

    _cuda()
    cfg = dataclasses.replace(BertConfig.tiny(), hidden_size=256,
                              num_heads=4)
    with dygraph.guard(fluid.CUDAPlace(0), seed=3):
        model = DygraphBert(cfg)
        opt = fluid.optimizer.Adam(learning_rate=1e-4)
        f = to_feed(_dy_feed(cfg.vocab_size, 4, 128))
        for _ in range(2):
            K.reset_launch_counts()
            loss, _, _ = model(f)
            loss.backward()
            opt.minimize(loss, parameter_list=model.parameters())
            model.clear_gradients()
            counts = K.launch_counts()
            assert counts["flash_attention_fwd"] == cfg.num_layers
            assert counts["flash_attention_dq"] == cfg.num_layers
            assert counts["flash_attention_dkv"] == cfg.num_layers


def _conv_predictor(tmp_path, batch=2, hw=64):
    import numpy as np

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import inference
    from paddle_tpu_torch.models.resnet import resnet_forward

    with fluid.unique_name.guard():
        main, start = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, start):
            net = resnet_forward(18, 10, (3, hw, hw), is_test=True,
                                 with_label=False)
    exe, scope = fluid.Executor(), fluid.Scope()
    exe.run(start, scope=scope)
    fluid.io.save_inference_model(str(tmp_path / "m"), ["img"],
                                  [net["logits"]], exe, main_program=main,
                                  scope=scope)
    pred = inference.create_paddle_predictor(
        inference.AnalysisConfig(str(tmp_path / "m")))
    img = np.random.RandomState(1).rand(batch, 3, hw, hw).astype(np.float32)
    return pred, img


@pytest.mark.cuda
def test_export_conv_runs_in_float32_while_the_process_allows_tf32(
        tmp_path):
    """The artifact's convolutions run in full float32 while
    ``cudnn.allow_tf32`` is True in the process (an exported graph does
    not carry ``ops.common.convolution``'s settings, so the artifact's run
    sets them), within 2e-5 normwise of the predictor; the process's
    settings are restored."""
    import numpy as np

    from paddle_tpu_torch import inference

    _cuda()
    cudnn = torch.backends.cudnn
    was = cudnn.allow_tf32, cudnn.deterministic
    cudnn.allow_tf32, cudnn.deterministic = True, False
    try:
        pred, img = _conv_predictor(tmp_path)
        (want,) = pred.run([img])
        inference.export_stablehlo(pred._program, {"img": (img.shape,
                                                           "float32")},
                                   pred.get_output_names(),
                                   str(tmp_path / "a.pt2"),
                                   scope=pred._scope)
        (got,) = inference.load_stablehlo(str(tmp_path / "a.pt2")).run(img)
        assert (cudnn.allow_tf32, cudnn.deterministic) == (True, False)
    finally:
        cudnn.allow_tf32, cudnn.deterministic = was
    err = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert err <= 2e-5, err


@pytest.mark.cuda
def test_export_keeps_the_kernels_as_operators_that_launch(tmp_path):
    """BERT-tiny fused inference exported: K1 and K5 enter the graph as
    the port's operators, and the loaded artifact launches and counts
    them as the predictor does."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import inference
    from paddle_tpu_torch.models.bert import BertConfig, build_bert_pretrain

    _cuda()
    cfg = BertConfig.tiny()
    with fluid.unique_name.guard():
        net = build_bert_pretrain(cfg, seq_len=64, build_optimizer=False)
    prog = net["main"].clone(for_test=True)
    exe, scope = fluid.Executor(), fluid.Scope()
    exe.run(net["startup"], scope=scope)
    feed = _dy_feed(cfg.vocab_size, 4, 64)
    fluid.io.save_inference_model(str(tmp_path / "m"), sorted(feed),
                                  [net["loss"]], exe, main_program=prog,
                                  scope=scope)
    fluid.set_flags({"FLAGS_epilogue_fusion": True})
    try:
        pred = inference.create_paddle_predictor(
            inference.AnalysisConfig(str(tmp_path / "m")))
        inputs = [feed[n] for n in pred.get_input_names()]
        pred.run(inputs)
        K.reset_launch_counts()
        (want,) = pred.run(inputs)
        by_pred = K.launch_counts()
        meta = inference.export_stablehlo(
            pred._program, {n: (v.shape, str(v.dtype))
                            for n, v in feed.items()},
            pred.get_output_names(), str(tmp_path / "a.pt2"),
            scope=pred._scope)
    finally:
        fluid.set_flags({"FLAGS_epilogue_fusion": False})
    text = open(str(tmp_path / "a.pt2.txt")).read()
    assert "paddle_tpu_torch.flash_attention_fwd" in text
    assert "paddle_tpu_torch.fused_gemm" in text
    art = inference.load_stablehlo(str(tmp_path / "a.pt2"))
    K.reset_launch_counts()
    (got,) = art.run(*[feed[n] for n in meta["feed_order"]])
    assert K.launch_counts() == by_pred
    assert by_pred["flash_attention_fwd"] == cfg.num_layers
    assert by_pred["fused_gemm"] > 0
    torch.testing.assert_close(torch.as_tensor(got), torch.as_tensor(want),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("op_type", [
    "fake_quantize_dequantize_abs_max",
    "fake_quantize_dequantize_moving_average_abs_max"])
def test_quant_levels_on_the_card_equal_the_cpu(op_type):
    """The fake-quant levels on the card equal the CPU's exactly, on
    values placed at and beside the rounding boundaries (the division by
    qmax is a true division: a reciprocal product would move them)."""
    from paddle_tpu_torch.core import registry
    from paddle_tpu_torch.lowering import LowerCtx

    g = _cuda()
    scale = 3.7
    k = torch.arange(-127, 128, dtype=torch.float32)
    half = (k + 0.5) * scale / 127.0
    v = torch.cat([k * scale / 127.0, half, torch.nextafter(half, half + 1),
                   torch.nextafter(half, half - 1),
                   torch.randn(4096, generator=g, device="cuda").cpu() * 2])
    ins = {"X": [v]}
    if "moving" in op_type:
        ins["InScale"] = [torch.tensor([scale])]
    rule = registry.get_op_def(op_type).lower
    attrs = {"bit_length": 8, "moving_rate": 0.9, "is_test": False}
    cpu = rule(LowerCtx("cpu"), ins, attrs)
    card = rule(LowerCtx("cuda"), {s: [t.cuda() for t in vals]
                                   for s, vals in ins.items()}, attrs)
    for slot in ("Out", "OutScale"):
        assert torch.equal(card[slot][0].cpu(), cpu[slot][0]), slot


# ---------------------------------------------------------------------------
# the fleet tier on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_fleet_wire_roundtrip_of_cuda_arrays():
    """f32 and bf16 arrays made on the card cross the wire bit for bit
    (a bf16 tensor travels as its raw 2-byte words)."""
    import json

    from paddle_tpu_torch.serving.fleet import wire

    g = _cuda()
    x = torch.randn(7, 33, generator=g, device="cuda")
    for t in (x @ x.T, (x @ x.T).bfloat16()):
        body = json.loads(wire.dumps(wire.encode_outputs([t], "t")))
        back, = wire.decode_outputs(body)
        back = back if isinstance(back, torch.Tensor) else \
            torch.from_numpy(back.view("int16")).view(torch.bfloat16) \
            if str(back.dtype) == "bfloat16" else torch.from_numpy(back)
        assert back.dtype == t.dtype and torch.equal(back, t.cpu())


def _gpt_tiny_engine():
    from paddle_tpu_torch import serving
    from paddle_tpu_torch.serving.fleet.replica import build_probe

    eng, _ = build_probe("gpt_tiny", serving.ServingConfig(
        max_batch=4, queue_depth=16), "cuda")
    return eng


@pytest.mark.cuda
def test_fleet_frontend_over_a_gpt_tiny_engine_on_the_card():
    """A gpt_tiny engine on cuda:0 behind a front-end: routed streams
    equal the engine's own answers, K1 and K2 launch, the health body
    advertises the generative capability and the ledgers stay exact."""
    from paddle_tpu_torch.serving.fleet import (FleetRouter, Replica,
                                                ServingFrontend)

    _cuda()
    eng = _gpt_tiny_engine()
    eng.warm_up()
    eng.start()
    fe = ServingFrontend(eng, replica_id="c0")
    fe.start()
    try:
        router = FleetRouter([Replica("c0", "127.0.0.1", fe.port)])
        router.poll_now()
        assert fe.health_body()["generative"] is True
        K.reset_launch_counts()
        for prompt in ([3, 1, 4], [2, 7, 1, 8, 2, 8]):
            toks = list(router.generate(prompt, max_new_tokens=6))
            want = eng.submit(prompt, max_new_tokens=6).result(
                timeout=120)[0].tolist()
            assert toks == want and len(toks) == 6
        counts = K.launch_counts()
        assert counts["flash_attention_fwd"] > 0
        assert counts["decode_attention"] > 0
        assert router.accounting()["exact"] and eng.accounting()["exact"]
    finally:
        fe.stop(wait_inflight_s=5.0)
        eng.stop(drain=True)


@pytest.mark.cuda
def test_aot_cache_warm_start_on_the_card(tmp_path):
    """Two gpt_tiny engines on the card from one warm-start cache: the
    second loads every prepared step (hits, no misses, no errors) and
    answers with the first one's tokens."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import aot_cache

    _cuda()
    fluid.set_flags({"FLAGS_aot_cache_dir": str(tmp_path)})
    try:
        toks, deltas = [], []
        for _ in range(2):
            eng = _gpt_tiny_engine()
            before = aot_cache.cache_stats()
            eng.warm_up()
            after = aot_cache.cache_stats()
            deltas.append({k: after[k] - before[k] for k in after})
            with eng:
                toks.append(eng.submit([5, 3, 1], max_new_tokens=6).result(
                    timeout=120)[0].tolist())
    finally:
        fluid.set_flags({"FLAGS_aot_cache_dir": ""})
    cold, warm = deltas
    assert cold["saves"] >= 2 and cold["hits"] == 0
    assert warm["hits"] == cold["saves"] and warm["misses"] == 0
    assert warm["errors"] == 0 and toks[0] == toks[1]


@pytest.mark.cuda
def test_lock_witness_bert_tiny_engine_on_the_card_stays_in_static_graph():
    """A BERT-tiny ServingEngine on cuda:0 under ``FLAGS_lock_witness``,
    requests from four threads and one transient compile fault at
    warm-up: every runtime lock-order edge between framework-named locks
    is in the port's static graph (``analysis.concurrency``), no runtime
    cycle, the accounting exact and K1 launched."""
    import threading

    import numpy as np

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import monitor, serving
    from paddle_tpu_torch.analysis.concurrency import analyze_package
    from paddle_tpu_torch.models.bert import BertConfig, build_bert_pretrain
    from paddle_tpu_torch.resilience import fault_plan_guard

    _cuda()
    static = analyze_package()
    fluid.set_flags({"FLAGS_lock_witness": 1})
    monitor.reset_witness()
    try:
        seq = 32
        net = build_bert_pretrain(BertConfig.tiny(), seq_len=seq,
                                  build_optimizer=False)
        infer = net["main"].clone(for_test=True)
        exe, scope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
        exe.run(net["startup"], scope=scope)
        eng = serving.ServingEngine(
            infer, feed_names=list(net["feeds"]),
            fetch_list=[net["loss"].name], scope=scope, executor=exe,
            config=serving.ServingConfig(max_batch=4, batch_window_s=0.005))
        with fault_plan_guard("compile:1:RuntimeError"):
            eng.warm_up()
        rng = np.random.RandomState(0)

        def feed(i):
            return {"src_ids": rng.randint(0, 100, (1, seq)),
                    "pos_ids": np.arange(seq, dtype=np.int64)[None],
                    "sent_ids": np.zeros((1, seq), np.int64),
                    "input_mask": np.ones((1, seq), np.float32),
                    "mask_label": np.full((1, seq), -100, np.int64),
                    "next_sent_label": np.zeros((1, 1), np.int64)}

        feeds = [feed(i) for i in range(16)]
        futs, lock = [], threading.Lock()

        def submit(part):
            for f in part:
                fut = eng.submit(f)
                with lock:
                    futs.append(fut)

        K.reset_launch_counts()
        with eng:
            threads = [threading.Thread(target=submit, args=(feeds[i::4],))
                       for i in range(4)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(120)
            for f in futs:
                assert np.isfinite(f.result(timeout=120)[0]).all()
        launches = K.launch_counts()
        report = monitor.witness_report()
        runtime = monitor.witness_edges()
    finally:
        monitor.reset_witness()
        fluid.set_flags({"FLAGS_lock_witness": 0})
    assert eng.accounting()["exact"] and len(futs) == 16
    assert launches["flash_attention_fwd"] > 0
    names = set(static.locks) | {n for e in static.edge_set() for n in e}
    framework = {e for e in runtime if e[0] in names and e[1] in names}
    assert framework - static.edge_set() == set()
    assert report["cycles"] == []
    assert {"ServingEngine._lock", "Executor._lock",
            "_CompiledStep._aot_lock"} <= set(report["locks"])


@pytest.mark.cuda
def test_chaos_check_bert_base_resumes_bit_for_bit_on_the_card(tmp_path):
    """``tools/torch_chaos_check.py --check --model bert_base`` on the
    card: BERT-base f32 killed inside a checkpoint write resumes from the
    last verified serial under compile faults and ends with the
    uninterrupted run's loss and parameter digest bit for bit, each
    worker process launching K1, K3 and K4."""
    import json
    import os
    import subprocess
    import sys

    _cuda()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    report = tmp_path / "chaos.json"
    proc = subprocess.run(
        [sys.executable, os.path.join(repo, "tools", "torch_chaos_check.py"),
         "--check", "--model", "bert_base", "--workdir",
         str(tmp_path / "work"), "--json", str(report)],
        cwd=repo, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    rep = json.loads(report.read_text())
    checks = {c["name"]: c["ok"] for c in rep["checks"]}
    assert all(checks.values()), checks
    assert {"final_params_bit_identical",
            "resume_launched_attention_kernels"} <= set(checks)
    assert not (tmp_path / "work").exists()


# ---------------------------------------------------------------- data
# parallel: two ranks started by the port's launcher on the card(s), each
# on card r modulo the cards (so gloo where they share one, NCCL where
# each has its own: distributed.collective_backend)

def _dp_launch(tmp_path, cases):
    import numpy as np

    import torch_dist_runner as R

    _cuda()
    rc, logs = R.launch(tmp_path, cases, backend="gpu", timeout=600)
    assert rc == 0, logs
    return np, R, R.results(tmp_path)


@pytest.mark.cuda
def test_data_parallel_collectives_over_the_rule_backend(tmp_path):
    import numpy as np

    from paddle_tpu_torch import distributed as dist

    np, R, ranks = _dp_launch(tmp_path, ["collectives"])
    env = dist.ParallelEnv()
    env.local_cards = [r % torch.cuda.device_count() for r in range(2)]
    env.local_nproc = 2
    want = dist.collective_backend(env)
    ref = np.array([-0.0, float("nan"), 1e-40], np.float32).view(np.int32)
    for r, res in enumerate(ranks):
        assert str(res["collectives/backend"][0]) == want
        assert str(res["collectives/device"][0]).startswith("cuda")
        np.testing.assert_array_equal(res["collectives/sum"],
                                      np.full((3, 2), 3.0, np.float32))
        np.testing.assert_array_equal(res["collectives/bcast"],
                                      np.ones(4, np.float32))
        bits = res["collectives/gather_bits"]
        assert bits.shape == (2, 4)
        for k in range(2):
            np.testing.assert_array_equal(bits[k, :3], ref)
        np.testing.assert_array_equal(res["collectives/gather_int"],
                                      [0, 1, 2, 1, 2, 3])
        full = np.arange(4.0) * 1 + np.arange(4.0) * 2
        np.testing.assert_array_equal(res["collectives/rscatter"],
                                      full[2 * r:2 * r + 2])


@pytest.mark.cuda
def test_data_parallel_step_equals_the_single_card_step_and_ckpt(tmp_path):
    """A small parallel step (the MLP, Adam, ZeRO-1 too) on the card
    equals the single-card step over the whole batch (rtol 1e-5: float32
    sums in another order), and the sharded checkpoint round trip resumes
    bit for bit."""
    import numpy as np

    import paddle_tpu_torch as fluid
    import torch_dist_runner as R

    _cuda()
    main, startup, loss = R.build_mlp(fluid, "adam")
    exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    exe.run(startup, scope=scope)
    init = {n: scope.numpy(n) for n in scope.vars}
    np.savez(tmp_path / "init_mlp_adam.npz", **init)
    from paddle_tpu_torch.interop import scope_from_numpy

    card = fluid.CUDAPlace(0)
    cscope = scope_from_numpy(init, fluid.Scope(), card, [main])
    cexe = fluid.Executor(card)
    feed = R.mlp_feeds()
    ref = [float(cexe.run(main, feed=feed, fetch_list=[loss],
                          scope=cscope)[0].reshape(-1)[0])
           for _ in range(R.STEPS)]
    rc, logs = R.launch(tmp_path, ["mlp_adam", "mlp_zero", "ckpt"],
                        backend="gpu", timeout=600)
    assert rc == 0, logs
    for res in R.results(tmp_path):
        for case in ("mlp_adam", "mlp_zero"):
            np.testing.assert_allclose(res[f"{case}/losses"], ref,
                                       rtol=1e-5, atol=1e-7)
        np.testing.assert_array_equal(res["ckpt/resumed"],
                                      res["ckpt/losses"][2:])
        np.testing.assert_array_equal(res["ckpt/w"], res["ckpt/w2"])


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True])
def test_ring_attention_blocks_launch_the_kernels_on_the_card(causal):
    """The ring body of two sp ranks, emulated in one process (the
    exchange hands each rank the other's K/V block): each rank launches
    K1 once a block with its global offsets, and the two output blocks
    equal dense attention over the whole sequence (f32,
    ``K.KERNEL_TOL``)."""
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.parallel import ring_attention as ra
    from paddle_tpu_torch.parallel.sharding import Mesh

    g = _cuda()
    B, T, H, D = 2, 256, 4, 64
    q, k, v = (torch.randn(B, T, H, D, generator=g, device="cuda") * 0.5
               for _ in range(3))
    Tl = T // 2
    blocks = {}
    saved = (dist._ring_exchange, dist.axis_group, dist.get_rank)
    outs = []
    try:
        dist.axis_group = lambda mesh, axis: (None, [0, 1])
        for me in (0, 1):
            dist.get_rank = lambda me=me: me
            other = 1 - me

            def exchange(t, group, ranks, shift=1, other=other):
                return blocks[other].pop(0)
            dist._ring_exchange = exchange
            for r in (0, 1):
                sl = slice(r * Tl, (r + 1) * Tl)
                blocks[r] = [x[:, sl].transpose(1, 2).reshape(B * H, Tl, D)
                             .contiguous() for x in (k, v)]
            n0 = K.launch_counts()["flash_attention_fwd"]
            sl = slice(me * Tl, (me + 1) * Tl)
            outs.append(ra.ring_attention_local(
                q[:, sl], k[:, sl], v[:, sl], "sp", causal=causal,
                mesh=Mesh({"sp": 2})))
            assert K.launch_counts()["flash_attention_fwd"] == n0 + 2
    finally:
        dist._ring_exchange, dist.axis_group, dist.get_rank = saved
    want = ra.attention_reference(q, k, v, causal=causal)
    torch.testing.assert_close(torch.cat(outs, 1), want,
                               **K.KERNEL_TOL[torch.float32])


@pytest.mark.cuda
def test_tensor_parallel_bert_tiny_equals_the_single_card_step(tmp_path):
    """BERT-tiny over {"tp": 2} on the card (the ranks share it under
    gloo, or take one each under NCCL) equals the single-card step from
    the same weights: the loss and the gathered gradients at step 1 (rtol
    1e-5, atol 1e-7: float32 partial products summed in another order)."""
    import numpy as np

    import paddle_tpu_torch as fluid
    import paddle_tpu_torch.unique_name as un
    import torch_dist_runner as R
    from paddle_tpu_torch.interop import scope_from_numpy
    from paddle_tpu_torch.models.bert import BertConfig, build_bert_pretrain

    _cuda()
    with un.guard():
        m = build_bert_pretrain(R.bert_cfg(BertConfig), seq_len=R.TP_SEQ)
    exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    exe.run(m["startup"], scope=scope)
    init = {n: scope.numpy(n) for n in scope.vars}
    np.savez(tmp_path / "init_tp.npz", **init)
    card = fluid.CUDAPlace(0)
    cscope = scope_from_numpy(init, fluid.Scope(), card, [m["main"]])
    names = R.param_grads(m["main"])
    ref = fluid.Executor(card).run(m["main"], feed=R.tp_feeds(),
                                   fetch_list=[m["loss"].name] + names,
                                   scope=cscope)
    rc, logs = R.launch(tmp_path, ["tp_bert"], backend="gpu", timeout=600)
    assert rc == 0, logs
    for res in R.results(tmp_path):
        np.testing.assert_allclose(res["tp_bert/losses"][0],
                                   float(ref[0].reshape(-1)[0]),
                                   rtol=1e-5, atol=1e-7)
        for n, want in zip(names, ref[1:]):
            np.testing.assert_allclose(res["tp_bert/grad/" + n], want,
                                       rtol=1e-5, atol=1e-7, err_msg=n)


@pytest.mark.cuda
def test_pipeline_region_on_the_card_equals_the_scan_path(tmp_path):
    """The region model over {"pp": 2} and BERT's block as the stage, each
    rank on the card (gloo, or a card each under NCCL), against the
    single-card scan path of the same program from the same weights: the
    losses at rtol 1e-5 (float32, the microbatches' sums in another
    order); the attention stage launches K1/K3/K4 on every rank."""
    import numpy as np

    import paddle_tpu_torch as fluid
    import torch_dist_runner as R
    from paddle_tpu_torch.interop import scope_from_numpy

    sys.path.insert(0, os.path.join(R.REPO, "tools"))
    import torch_mp_worker as W

    _cuda()
    card = fluid.CUDAPlace(0)
    main, startup, loss = R.build_region(fluid, 2)
    exe, scope = fluid.Executor(card), fluid.Scope()
    exe.run(startup, scope=scope)
    init = R.region_init(2)
    R.plant_region(scope, init, card)
    feed = {n: init[n] for n in ("x", "y")}
    ref = [float(exe.run(main, feed=feed, fetch_list=[loss],
                         scope=scope)[0].reshape(-1)[0])
           for _ in range(R.PP_STEPS)]
    amain, astart, aloss = W.build_pipeline_encoder(fluid, **R.PP_ATTN)
    cpu = fluid.Scope()
    fluid.Executor(fluid.CPUPlace()).run(astart, scope=cpu)
    ainit = {n: cpu.numpy(n) for n in cpu.vars}
    np.savez(tmp_path / "init_pp_attn.npz", **ainit)
    ascope = scope_from_numpy(ainit, fluid.Scope(), card, [amain])
    afeed = W.pipeline_feed(0, R.PP_ATTN_BATCH, R.PP_ATTN["seq"],
                            R.PP_ATTN["vocab"])
    aref = [float(exe.run(amain, feed=afeed, fetch_list=[aloss],
                          scope=ascope)[0].reshape(-1)[0])
            for _ in range(R.PP_ATTN_STEPS)]
    rc, logs = R.launch(tmp_path, ["pp2", "pp_attn"], backend="gpu",
                        timeout=600)
    assert rc == 0, logs
    for res in R.results(tmp_path):
        np.testing.assert_allclose(res["pp2/losses"], ref, rtol=1e-5)
        np.testing.assert_allclose(res["pp_attn/losses"], aref, rtol=1e-5)


@pytest.mark.cuda
def test_sparse_tables_under_the_parallel_step_on_the_card(tmp_path):
    """DeepFM row-sharded (vocab 64) and replicated (vocab 65) over two
    ranks on the card, and the sparse lookup into a tp-sharded table,
    against the single-card step from the same weights: losses rtol 1e-5
    (the row-sharded lookups are exact; the MLP's halves sum in another
    order), the tables after the last step rtol 1e-4 / atol 1e-6."""
    import numpy as np

    import paddle_tpu_torch as fluid
    import torch_dist_runner as R
    from paddle_tpu_torch.interop import scope_from_numpy
    from paddle_tpu_torch.models.deepfm import build_deepfm

    _cuda()
    card = fluid.CUDAPlace(0)
    refs = {}
    for vocab in (64, 65):
        with fluid.unique_name.guard():
            m = build_deepfm(vocab=vocab, **R.FM)
        cpu = fluid.Scope()
        fluid.Executor(fluid.CPUPlace()).run(m["startup"], scope=cpu)
        init = {n: cpu.numpy(n) for n in cpu.vars}
        np.savez(tmp_path / f"init_fm_{vocab}.npz", **init)
        cscope = scope_from_numpy(init, fluid.Scope(), card, [m["main"]])
        exe = fluid.Executor(card)
        feed = R.fm_feeds(vocab)
        losses = [float(exe.run(m["main"], feed=feed,
                                fetch_list=[m["loss"]],
                                scope=cscope)[0].reshape(-1)[0])
                  for _ in range(R.FM_STEPS)]
        refs[vocab] = (losses, cscope.numpy("fm_v"))
    main, startup, loss = R.build_sparse_tp(fluid)
    sscope = fluid.Scope()
    exe = fluid.Executor(card)
    exe.run(startup, scope=sscope)
    tp_ref = [float(exe.run(main, feed=R.sparse_tp_feeds(),
                            fetch_list=[loss], scope=sscope)[0]
                    .reshape(-1)[0]) for _ in range(R.SPARSE_TP["steps"])]
    rc, logs = R.launch(tmp_path, ["fm_rows", "fm_replicated", "tp_sparse"],
                        backend="gpu", timeout=600)
    assert rc == 0, logs
    for res in R.results(tmp_path):
        for case, vocab in (("fm_rows", 64), ("fm_replicated", 65)):
            np.testing.assert_allclose(res[f"{case}/losses"],
                                       refs[vocab][0], rtol=1e-5)
            np.testing.assert_allclose(res[f"{case}/fm_v"], refs[vocab][1],
                                       rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(res["tp_sparse/losses"], tp_ref,
                                   rtol=1e-5)
