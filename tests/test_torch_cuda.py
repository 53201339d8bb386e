"""The PyTorch port's CUDA kernels against their plain versions, on the
card. These tests import no JAX, so they also run where only PyTorch is
installed:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Without a CUDA device they skip: the kernels have no CPU mode."""
import importlib

import pytest
import torch

from paddle_tpu_torch import kernels as K
from paddle_tpu_torch.kernels import _build

# the module (the package re-exports its function under the same name)
FG = importlib.import_module("paddle_tpu_torch.kernels.fused_gemm")


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
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


def _check_gemm(m, n, k, epilogue, in_dt, out_dt):
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
    got = K.fused_gemm(x, y, **args)
    assert K.fused_gemm.launches == n0 + 1
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
                      None, 0, 8, 8, 0, 0, 1e-5, 0, 0)

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


# the routes of each source, by the kernel names in its SASS
ROUTES = {"fused_gemm": (("gemm_bf16_kernel", "gemm_ln_bf16_kernel"),
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
