"""The PyTorch port's CUDA kernels against their plain versions, on the
card. These tests import no JAX, so they also run where only PyTorch is
installed:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Without a CUDA device they skip: the kernels have no CPU mode."""
import pytest
import torch

from paddle_tpu_torch import kernels as K


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
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,q_offset,k_offset,rate", [
    (False, 0, 0, 0.0), (False, 0, 0, 0.1), (True, 0, 0, 0.0),
    (True, 0, 0, 0.1), (True, 0, 40, 0.0), (True, 40, 0, 0.1)])
def test_backward_kernels_match_plain_versions(dtype, causal, q_offset,
                                               k_offset, rate):
    """K3 (dQ) and K4 (dK, dV) against their plain versions on ragged
    shapes (Sq = 77, Sk = 130), with bias, causal offsets (a dead-row case
    included: k_offset = 40 leaves the first 40 rows no key) and dropout."""
    g = _cuda()
    dt = getattr(torch, dtype)
    tol = K.KERNEL_TOL[dt]
    args = _bwd_inputs(g, 6, 77, 130, 64, dt, q_offset, k_offset, causal)
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
        assert got.dtype == dt and torch.isfinite(got.float()).all()
        torch.testing.assert_close(got.float(), want.float(), **tol)


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
