"""The PyTorch port's attention kernels: plain versions against the JAX
package's Pallas kernels (interpret mode), the paged KV appends, the
Hopper shape rules and the q_len > 8 slicing rule, on the CPU. The
CUDA kernels themselves run only on the card (tests/test_torch_cuda.py)."""
import ctypes
import os
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.kernels import (flash_attention_decode as j_decode,
                                flash_attention_with_lse as j_flash,
                                paged_kv_append as j_append,
                                paged_kv_append_rows as j_append_rows)

from paddle_tpu_torch import kernels as K
from paddle_tpu_torch.kernels import _build

RNG = np.random.RandomState(23)
ATOL, RTOL = 2e-5, 1e-4


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_plain_matches_jax_kernel(with_bias, causal):
    B, H, S, D = 2, 2, 16, 32
    q, k, v = (RNG.randn(B * H, S, D).astype(np.float32) for _ in range(3))
    bias = None
    if with_bias:
        bias = np.where(np.arange(S)[None] < np.array([[S], [9]]), 0.0,
                        -10000.0).astype(np.float32)
    jo, jl = j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     bias=None if bias is None else jnp.asarray(bias),
                     causal=causal, num_heads=H, interpret=True)
    to, tl = K.flash_attention_with_lse(
        _t(q), _t(k), _t(v), bias=None if bias is None else _t(bias),
        causal=causal, num_heads=H)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=ATOL,
                               rtol=RTOL)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                               rtol=RTOL)


def test_flash_plain_offsets_and_dead_rows_match_jax_kernel():
    """Causal on global positions; a key block wholly in the future of
    every query gives o = 0 and lse = -inf, as the TPU kernel does."""
    S, D = 16, 32
    q, k, v = (RNG.randn(2, S, D).astype(np.float32) for _ in range(3))
    for q_off, k_off in ((16, 0), (0, 16), (8, 4)):
        jo, jl = j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         causal=True, q_offset=q_off, k_offset=k_off,
                         interpret=True)
        to, tl = K.flash_attention_with_lse(_t(q), _t(k), _t(v), causal=True,
                                            q_offset=q_off, k_offset=k_off)
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=ATOL,
                                   rtol=RTOL)
        np.testing.assert_array_equal(np.isinf(tl.numpy()),
                                      np.isinf(np.asarray(jl)))
        fin = np.isfinite(np.asarray(jl))
        np.testing.assert_allclose(tl.numpy()[fin], np.asarray(jl)[fin],
                                   atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("q_len", [1, 3, 8])
@pytest.mark.parametrize("lengths", [(1, 5, 8), (8, 9, 16), (24, 31, 32)])
def test_decode_plain_matches_jax_kernel(lengths, q_len):
    B, H, S, D, P = 3, 2, 32, 64, 8
    q = RNG.randn(B * H, q_len, D).astype(np.float32)
    kc, vc = (RNG.randn(B * H, S, D).astype(np.float32) for _ in range(2))
    lens = np.asarray(lengths, np.int32)
    jo = j_decode(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), lens,
                  num_heads=H, page_size=P, interpret=True)
    to = K.flash_attention_decode(_t(q), _t(kc), _t(vc), _t(lens),
                                  num_heads=H)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=ATOL,
                               rtol=RTOL)


def test_q_len_over_8_runs_as_8_row_slices():
    """Slice j of a long chunk is the chunk whose row 0 sees lengths + 8j
    keys: slicing reproduces the whole-chunk plain version exactly."""
    B, H, S, D, C = 2, 3, 48, 16, 13
    q = _t(RNG.randn(B * H, C, D).astype(np.float32))
    kc, vc = (_t(RNG.randn(B * H, S, D).astype(np.float32))
              for _ in range(2))
    lens = torch.tensor([4, 30], dtype=torch.int32)
    whole = K.decode_attention_reference(q, kc, vc,
                                         lens.repeat_interleave(H), 0.25)
    calls = []

    def attend(qs, ls):
        calls.append((qs.shape[1], ls.tolist()))
        return K.decode_attention_reference(qs, kc, vc,
                                            ls.repeat_interleave(H), 0.25)

    sliced = K.decode_in_slices(q, lens, attend)
    assert calls == [(8, [4, 30]), (5, [12, 38])]
    np.testing.assert_allclose(sliced.numpy(), whole.numpy(), atol=1e-6,
                               rtol=1e-6)


@pytest.mark.parametrize("positions,L", [((7, 8, 31), 1), ((0, 0, 0), 8),
                                         ((37, 37, 37), 1), ((28, 3, 30), 8)])
def test_paged_kv_append_clamps_like_jax(positions, L):
    B, H, S, D = 3, 2, 32, 4
    cache = RNG.randn(B, H, S, D).astype(np.float32)
    new = RNG.randn(B, H, L, D).astype(np.float32)
    pos = np.asarray(positions, np.int32)
    want = np.asarray(j_append(jnp.asarray(cache), jnp.asarray(new),
                               jnp.asarray(pos)))
    got = K.paged_kv_append(_t(cache), _t(new), _t(pos).long())
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("positions", [(0, 5, 29), (30, 31, 40)])
def test_paged_kv_append_rows_clamps_per_row_like_jax(positions):
    B, H, S, D, C = 3, 2, 32, 4, 4
    cache = RNG.randn(B, H, S, D).astype(np.float32)
    new = RNG.randn(B, H, C, D).astype(np.float32)
    pos = np.asarray(positions, np.int32)
    want = np.asarray(j_append_rows(jnp.asarray(cache), jnp.asarray(new),
                                    jnp.asarray(pos)))
    got = K.paged_kv_append_rows(_t(cache), _t(new), _t(pos).long())
    np.testing.assert_array_equal(got.numpy(), want)


def test_appends_leave_unmasked_slots_bit_untouched():
    B, H, S, D = 2, 1, 16, 4
    cache = _t(RNG.randn(B, H, S, D).astype(np.float32))
    before = cache.clone()
    new = _t(RNG.randn(B, H, 4, D).astype(np.float32))
    mask = torch.tensor([[1.0], [0.0]])
    K.paged_kv_append_rows(cache, new, torch.tensor([14, 14]), mask)
    assert torch.equal(cache[1], before[1])
    assert torch.equal(cache[0, :, 14], new[0, :, 0])
    assert torch.equal(cache[0, :, 15], new[0, :, 3])   # last row wins
    K.paged_kv_append(cache, new, torch.tensor([0, 0]), mask)
    assert torch.equal(cache[1], before[1])
    assert torch.equal(cache[0, :, :4], new[0])


@pytest.mark.parametrize("sq,sk,d,ok", [
    (1, 1024, 64, True), (100, 333, 64, True), (7, 7, 128, True),
    (16, 16, 136, False), (16, 16, 60, False), (0, 16, 64, False),
    (16, 0, 64, False)])
def test_classify_shapes_refuses_with_a_reason(sq, sk, d, ok):
    kind, why = K.classify_shapes(sq, sk, d)
    assert (kind != "unsupported") == ok, why
    if not ok:
        assert ("head_dim" in why) or (">= 1" in why)


@pytest.mark.parametrize("name", sorted(K.KERNEL_SOURCES))
def test_ctypes_signature_matches_the_c_entry_point(name):
    """The argument types bound to each entry point follow its C
    declaration in ``csrc/<name>.cu``, parameter by parameter."""
    src = open(os.path.join(_build.CSRC, name + ".cu")).read()
    decl = re.search(r'extern "C" int ' + name + r"\((.*?)\)", src, re.S)
    kinds = [ctypes.c_void_p if "*" in p else
             ctypes.c_float if "float" in p else ctypes.c_int
             for p in decl.group(1).split(",")]
    assert _build.SIGNATURES[name] == kinds


def test_cpu_tensors_never_count_a_launch():
    K.reset_launch_counts()
    q = torch.randn(2, 8, 16)
    K.flash_attention_with_lse(q, q, q, causal=True)
    K.flash_attention_decode(q[:, :1], q, q, torch.tensor([3, 8]),
                             num_heads=1)
    assert K.launch_counts() == {"flash_attention_fwd": 0,
                                 "decode_attention": 0}
