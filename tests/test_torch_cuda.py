"""The PyTorch port's CUDA kernels against their plain versions, on the
card. These tests import no JAX, so they also run where only PyTorch is
installed:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Without a CUDA device they skip: the kernels have no CPU mode."""
import pytest
import torch

from paddle_tpu_torch import kernels as K


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernels_match_plain_versions(dtype):
    """On the card: both kernels against their plain versions, ragged
    shapes included, at ``K.KERNEL_TOL``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    dt = getattr(torch, dtype)
    tol = K.KERNEL_TOL[dt]
    g = torch.Generator(device="cuda").manual_seed(0)
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
