"""The PyTorch port's kernels: plain versions against the JAX package's
Pallas kernels (interpret mode) — attention forward and backward, the
Philox dropout mask, the paged KV appends, the fused GEMM + epilogue — the
Hopper shape rules and the q_len > 8 slicing rule, on the CPU. The CUDA
kernels themselves run only on the card (tests/test_torch_cuda.py)."""
import ctypes
import importlib
import os
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.kernels.fused_gemm import fused_gemm as j_gemm
from paddle_tpu.kernels.fused_gemm import (fused_gemm_reference as
                                           j_gemm_reference)
from paddle_tpu.kernels import (flash_attention as j_flash_o,
                                flash_attention_decode as j_decode,
                                flash_attention_with_lse as j_flash,
                                paged_kv_append as j_append,
                                paged_kv_append_rows as j_append_rows)

from paddle_tpu_torch import kernels as K
from paddle_tpu_torch.kernels import _build

# the module (the package re-exports its function under the same name)
KD = importlib.import_module("paddle_tpu_torch.kernels.decode_attention")

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


@pytest.mark.parametrize("q_len", [1, 3, 8])
@pytest.mark.parametrize("page_size", [8, 32])
def test_decode_plain_matches_jax_kernel_in_bf16(page_size, q_len):
    """bf16 caches: the plain version casts P to bf16 before P.V, as the
    JAX kernel does (``p.astype(v_ref.dtype)``). With one page (page_size
    = S_max) the JAX kernel's running max is the row max, so both round
    the same P and agree bit for bit (without the cast about 30 % of the
    outputs differ by a bf16 ulp); with 8-key pages the JAX kernel rounds
    P against a running max: within ``KERNEL_TOL[bf16]``."""
    B, H, S, D = 3, 2, 32, 64
    q = RNG.randn(B * H, q_len, D).astype(np.float32)
    kc, vc = (RNG.randn(B * H, S, D).astype(np.float32) for _ in range(2))
    lens = np.asarray((1, 9, 24), np.int32)
    jq, jk, jv = (jnp.asarray(a).astype(jnp.bfloat16) for a in (q, kc, vc))
    jo = np.asarray(j_decode(jq, jk, jv, lens, num_heads=H,
                             page_size=page_size, interpret=True)
                    .astype(jnp.float32))
    tq, tk, tv = (_t(a).to(torch.bfloat16) for a in (q, kc, vc))
    to = K.flash_attention_decode(tq, tk, tv, _t(lens), num_heads=H)
    assert to.dtype == torch.bfloat16
    if page_size == S:
        np.testing.assert_array_equal(to.float().numpy(), jo)
    else:
        np.testing.assert_allclose(to.float().numpy(), jo,
                                   **K.KERNEL_TOL[torch.bfloat16])


@pytest.mark.parametrize("S", [1, 16, 96, 128, 129, 1000, 1024, 1025, 4096])
def test_decode_split_covers_the_cache_in_at_most_8_blocks(S):
    """The kernel's split-K: ceil(S / SPLIT_KEYS) blocks of at most
    SPLIT_KEYS keys up to S_max = 8 * SPLIT_KEYS, then 8 longer ones; a
    multiple of 16 keys each, and no block past the cache's end."""
    split, most = KD.split_keys(S), KD.SPLIT_KEYS
    n = -(-S // split)
    assert split % 16 == 0 and n == min(KD.MAX_SPLITS, -(-S // most))
    assert split * (n - 1) < S <= split * n
    assert split <= most or S > KD.MAX_SPLITS * most


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
    q = torch.randn(2, 8, 16, requires_grad=True)
    o, _ = K.flash_attention_with_lse(q, q, q, causal=True, dropout_rate=0.1,
                                      seed=3)
    o.sum().backward()
    K.flash_attention_decode(q[:, :1], q, q, torch.tensor([3, 8]),
                             num_heads=1)
    K.fused_gemm(torch.randn(5, 8), torch.randn(8, 4), layer_norm=True)
    assert K.launch_counts() == {"flash_attention_fwd": 0,
                                 "decode_attention": 0,
                                 "flash_attention_dq": 0,
                                 "flash_attention_dkv": 0,
                                 "fused_gemm": 0}


# Gradients through the flash attention: the port's autograd.Function (on
# the CPU its backward is the explicit plain dQ / dK,dV formulas) against
# jax.grad through the JAX package's custom_vjp (its _dq_kernel and
# _dkv_kernel in interpret mode), as tests/test_flash_attention.py checks
# the TPU kernels against the primitive path. Tolerance as there.
GRAD_ATOL, GRAD_RTOL = 5e-4, 1e-3


def _qkv(BH, S, D=64):
    return [RNG.randn(BH, S, D).astype(np.float32) for _ in range(3)]


def _torch_grads(loss_fn, *arrays):
    ts = [_t(a).requires_grad_() for a in arrays]
    return [g.numpy() for g in torch.autograd.grad(loss_fn(*ts), ts)]


@pytest.mark.parametrize("causal", [False, True])
def test_flash_gradients_match_jax_kernels(causal):
    q, k, v = _qkv(2, 128)
    bias = np.where(RNG.rand(2, 128) > 0.25, 0.0, -10000.0).astype(
        np.float32)

    def j_loss(q, k, v):
        return jnp.sum(jnp.tanh(j_flash_o(q, k, v, bias=jnp.asarray(bias),
                                          causal=causal, num_heads=1,
                                          interpret=True)))

    def t_loss(q, k, v):
        return torch.tanh(K.flash_attention(q, k, v, bias=_t(bias),
                                            causal=causal, num_heads=1)).sum()

    want = jax.grad(j_loss, argnums=(0, 1, 2))(q, k, v)
    for a, b in zip(_torch_grads(t_loss, q, k, v), want):
        np.testing.assert_allclose(a, np.asarray(b), atol=GRAD_ATOL,
                                   rtol=GRAD_RTOL)


def test_lse_combination_differentiates_like_jax():
    """Two kernel calls over halves of the keys recombined through lse:
    values and gradients equal the JAX package's, so the lse cotangent
    reaches dQ and dK."""
    q, k, v = _qkv(2, 256)
    halves = [k[:, :128], k[:, 128:], v[:, :128], v[:, 128:]]

    def combine(lib, fn, exp):
        def loss(q, k1, k2, v1, v2):
            o1, l1 = fn(q, k1, v1)
            o2, l2 = fn(q, k2, v2)
            l = lib.logaddexp(l1, l2)
            o = o1 * exp(l1 - l)[..., None] + o2 * exp(l2 - l)[..., None]
            return lib.tanh(o).sum()
        return loss

    j_loss = combine(jnp, lambda q, k, v: j_flash(q, k, v, interpret=True),
                     jnp.exp)
    t_loss = combine(torch, K.flash_attention_with_lse, torch.exp)
    np.testing.assert_allclose(
        float(t_loss(*(_t(a) for a in [q] + halves))),
        float(j_loss(q, *halves)), rtol=1e-5)
    want = jax.grad(j_loss, argnums=(0, 1, 2, 3, 4))(q, *halves)
    for a, b in zip(_torch_grads(t_loss, q, *halves), want):
        np.testing.assert_allclose(a, np.asarray(b), atol=GRAD_ATOL,
                                   rtol=GRAD_RTOL)


def test_dead_rows_give_zero_output_and_zero_grads():
    """Every key causally in the future of every query: o = 0, lse = -inf,
    and all three gradients exactly 0, as the JAX package's kernels give."""
    q, k, v = _qkv(2, 128)
    jo, jl = j_flash(q, k, v, causal=True, k_offset=128, interpret=True)
    o, lse = K.flash_attention_with_lse(_t(q), _t(k), _t(v), causal=True,
                                        k_offset=128)
    assert torch.all(o == 0) and torch.all(torch.isneginf(lse))
    assert np.all(np.asarray(jo) == 0) and np.all(np.isneginf(jl))
    grads = _torch_grads(lambda q, k, v: K.flash_attention_with_lse(
        q, k, v, causal=True, k_offset=128)[0].sum(), q, k, v)
    for g in grads:
        assert np.all(np.isfinite(g)) and np.all(g == 0)


def test_dq_dkv_wrappers_match_autograd_of_the_plain_forward():
    """The explicit backward formulas (K3/K4's plain versions) against
    torch autograd of the plain forward, with dropout and an lse
    cotangent, on ragged shapes."""
    q = _t(RNG.randn(6, 37, 32).astype(np.float32))
    k, v = (_t(RNG.randn(6, 53, 32).astype(np.float32)) for _ in range(2))
    bias = torch.zeros(2, 53)
    bias[1, 40:] = -10000.0
    kw = dict(bias=bias, causal=True, q_offset=20, num_heads=3,
              dropout_rate=0.2, seed=99)
    do = _t(RNG.randn(6, 37, 32).astype(np.float32))
    dlse = _t(RNG.randn(6, 37).astype(np.float32))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    o, lse = K.flash_attention_reference(*leaves, **kw)
    want = torch.autograd.grad((o * do).sum() + (lse * dlse).sum(), leaves)
    o, lse = K.flash_attention_reference(q, k, v, **kw)
    delta = (do * o).sum(-1) - dlse
    args = (q, k, v, bias, do, lse, delta)
    bkw = {n: kw[n] for n in ("causal", "q_offset", "num_heads",
                              "dropout_rate", "seed")}
    dq = K.flash_attention_dq(*args, **bkw)
    dk, dv = K.flash_attention_dkv(*args, **bkw)
    for a, b in zip((dq, dk, dv), want):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-4)


# Philox4x32-10 known-answer vectors (Random123's kat_vectors: counter
# words, key words -> output words)
PHILOX_KAT = [
    ((0, 0, 0, 0), (0, 0),
     (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
    ((0xffffffff,) * 4, (0xffffffff,) * 2,
     (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
    ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
     (0xa4093822, 0x299f31d0),
     (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1)),
]


@pytest.mark.parametrize("ctr,key,want", PHILOX_KAT)
def test_philox_known_answers(ctr, key, want):
    words = K.philox4x32_10(*(torch.tensor([w], dtype=torch.int64)
                              for w in ctr + key))
    assert tuple(int(w) for w in words) == want


def test_dropout_mask_is_a_function_of_its_key():
    a = K.dropout_keep(7, 4, 64, 96, 0.1)
    assert torch.equal(a, K.dropout_keep(7, 4, 64, 96, 0.1))
    assert not torch.equal(a, K.dropout_keep(8, 4, 64, 96, 0.1))
    # the mask of an element does not depend on the extent around it
    assert torch.equal(a[:2, :30, :50], K.dropout_keep(7, 2, 30, 50, 0.1))


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_dropout_keep_rate_within_four_sigma(rate):
    keep = K.dropout_keep(2024, 8, 128, 128, rate)
    n = keep.numel()
    sigma = (rate * (1 - rate) / n) ** 0.5
    assert abs(keep.float().mean().item() - (1 - rate)) < 4 * sigma


def test_flash_dropout_is_identical_across_calls():
    q, k, v = (_t(a) for a in _qkv(4, 64, 32))
    a = K.flash_attention_with_lse(q, k, v, dropout_rate=0.1, seed=5)
    b = K.flash_attention_with_lse(q, k, v, dropout_rate=0.1, seed=5)
    c = K.flash_attention_with_lse(q, k, v, dropout_rate=0.1, seed=6)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert not torch.equal(a[0], c[0])
    # lse is the undropped normaliser
    assert torch.equal(a[1], K.flash_attention_with_lse(q, k, v)[1])


@pytest.mark.parametrize("sq,sk,d,ok", [
    (128, 128, 64, True), (77, 130, 128, True), (1, 1, 8, True),
    (16, 16, 136, False), (16, 16, 12, False), (0, 16, 64, False)])
def test_classify_backward_shapes_refuses_with_a_reason(sq, sk, d, ok):
    kind, why = K.classify_backward_shapes(sq, sk, d)
    assert (kind == "backward") == ok, why
    if ok:
        assert f"head_dim {d} run as {64 if d <= 64 else 128}" in why
    else:
        assert ("head_dim" in why) or (">= 1" in why)


@pytest.mark.parametrize("causal", [False, True])
def test_bf16_backward_plain_matches_jax_kernels(causal):
    """K3/K4's plain versions on bf16 inputs against ``jax.vjp`` through the
    JAX package's kernels in interpret mode (its _dq_kernel and _dkv_kernel
    cast dS and P_dropped to bf16 before their second products, as the
    plain versions and the kernels' tensor-core routes do), with a padding
    bias and an lse cotangent, at ``KERNEL_TOL[bf16]``. The JAX forward's
    o and lse feed both backwards, so only the backward is compared."""
    BH, S, D, H = 4, 128, 64, 2
    rng = np.random.RandomState(7)
    q, k, v, do = (rng.randn(BH, S, D).astype(np.float32) for _ in range(4))
    dlse = (0.1 * rng.randn(BH, S)).astype(np.float32)
    bias = np.where(np.arange(S)[None] < np.array([[S], [90]]), 0.0,
                    -10000.0).astype(np.float32)
    jq, jk, jv, jdo = (jnp.asarray(a).astype(jnp.bfloat16)
                       for a in (q, k, v, do))
    (jo, jl), vjp = jax.vjp(
        lambda q, k, v: j_flash(q, k, v, bias=jnp.asarray(bias),
                                causal=causal, num_heads=H, interpret=True),
        jq, jk, jv)
    want = vjp((jdo, jnp.asarray(dlse)))
    tq, tk, tv, tdo = (_t(a).to(torch.bfloat16) for a in (q, k, v, do))
    o = _t(np.asarray(jo.astype(jnp.float32)))
    lse = _t(np.asarray(jl))
    delta = (tdo.float() * o).sum(-1) - _t(dlse)
    args = (tq, tk, tv, _t(bias), tdo, lse, delta)
    kw = dict(causal=causal, num_heads=H)
    dq = K.flash_attention_dq(*args, **kw)
    dk, dv = K.flash_attention_dkv(*args, **kw)
    for got, w in zip((dq, dk, dv), want):
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(
            got.float().numpy(), np.asarray(w.astype(jnp.float32)),
            **K.KERNEL_TOL[torch.bfloat16])


# The fused GEMM + epilogue (K5): the plain version against the JAX
# package's kernel in interpret mode and its oracle, at the JAX package's
# tile-boundary shapes (tests/test_epilogue_fusion.py) and with every
# epilogue; the CPU wrapper takes the plain version. f32 tolerance as
# there (two f32 GEMMs summing in different orders); bf16 inputs: both
# accumulate exact bf16 products in f32 and round once, so one bf16 ulp.
GEMM_RTOL, GEMM_ATOL = 2e-4, 1e-4


def _gemm_args(m, n, k, kind, dtype=np.float32, seed=1):
    rng = np.random.RandomState(seed)
    x, y = rng.randn(m, k), rng.randn(k, n)
    kw, arrays = {}, {}
    if kind != "plain":
        arrays["bias"] = rng.randn(n)
    if "relu" in kind:
        kw["activation"] = "relu"
    if "gelu" in kind:
        kw["activation"] = "gelu"
        kw["gelu_approximate"] = "tanh" in kind
    if "residual" in kind:
        arrays["residual"] = rng.randn(m, n)
    if "ln" in kind:
        kw["layer_norm"] = True
        arrays["ln_scale"], arrays["ln_bias"] = rng.randn(n), rng.randn(n)
    cast = {k: v.astype(np.float32) for k, v in arrays.items()}
    return x.astype(dtype), y.astype(dtype), cast, kw


@pytest.mark.parametrize("shape", [(128, 128, 128), (64, 128, 256),
                                   (256, 384, 128), (8, 128, 128)])
@pytest.mark.parametrize("kind", ["plain", "bias+gelu", "ln", "bias+relu",
                                  "bias+residual", "bias+gelu_tanh",
                                  "bias+gelu+residual+ln"])
def test_fused_gemm_plain_matches_jax_kernel(shape, kind):
    m, n, k = shape
    x, y, arrays, kw = _gemm_args(m, n, k, kind)
    jx = {k: jnp.asarray(v) for k, v in arrays.items()}
    jk = np.asarray(j_gemm(jnp.asarray(x), jnp.asarray(y), interpret=True,
                           **jx, **kw))
    jr = np.asarray(j_gemm_reference(jnp.asarray(x), jnp.asarray(y), **jx,
                                     **kw))
    tx = {k: _t(v) for k, v in arrays.items()}
    tp = K.fused_gemm_reference(_t(x), _t(y), **tx, **kw).numpy()
    tw = K.fused_gemm(_t(x), _t(y), **tx, **kw).numpy()     # CPU: plain
    np.testing.assert_allclose(tp, jk, rtol=GEMM_RTOL, atol=GEMM_ATOL)
    np.testing.assert_allclose(tp, jr, rtol=GEMM_RTOL, atol=GEMM_ATOL)
    assert np.array_equal(tw, tp)


@pytest.mark.parametrize("kind", ["bias+gelu", "ln"])
def test_fused_gemm_plain_takes_bf16_like_jax_kernel(kind):
    """bf16 x and y, f32 epilogue params: f32 accumulation and one cast,
    to bf16 (the default, x's type) and to f32."""
    import ml_dtypes

    x, y, arrays, kw = _gemm_args(128, 256, 128, kind)
    xb, yb = x.astype(ml_dtypes.bfloat16), y.astype(ml_dtypes.bfloat16)
    jx = {k: jnp.asarray(v) for k, v in arrays.items()}
    tx = {k: _t(v) for k, v in arrays.items()}
    tb = [torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
          for a in (xb, yb)]
    for out in (None, "float32"):
        jk = np.asarray(j_gemm(jnp.asarray(xb), jnp.asarray(yb),
                               interpret=True, out_dtype=out, **jx, **kw))
        tp = K.fused_gemm_reference(
            *tb, out_dtype=getattr(torch, out) if out else None, **tx, **kw)
        assert tp.dtype == (torch.float32 if out else torch.bfloat16)
        tol = dict(rtol=GEMM_RTOL, atol=GEMM_ATOL) if out else \
            dict(rtol=1.6e-2, atol=8e-3)
        np.testing.assert_allclose(tp.float().numpy(),
                                   jk.astype(np.float32), **tol)


@pytest.mark.parametrize("mnk,kw,ok,why", [
    ((128, 128, 128), {}, True, ""),
    # ragged M and N: masked in the kernel (the TPU kernel refuses both)
    ((100, 132, 128), {}, True, ""),
    ((250, 100, 36), {}, True, ""),
    ((128, 1524, 768), {"layer_norm": True}, True, ""),
    ((1, 4, 4), {}, True, ""),
    ((65535 * 128, 4, 4), {}, True, ""),
    ((128, 130, 128), {}, False, "n=130 not a multiple of 4"),
    ((128, 128, 6), {}, False, "k=6 not a multiple of 4"),
    ((128, 2, 768), {}, False, "n=2 not a multiple of 4"),
    ((128, 1528, 768), {"layer_norm": True}, False, "whole rows"),
    ((128, 128, 128), {"block_k": 16}, False, "compiled instantiation"),
    ((128, 128, 128), {"block_n": 512}, False, "(128, 256, 32)"),
    ((65535 * 128 + 1, 4, 4), {}, False, "65535 row tiles"),
    ((0, 128, 128), {}, False, ">= 1")])
def test_classify_gemm_names_the_hopper_constraint(mnk, kw, ok, why):
    kind, reason = K.classify_gemm(*mnk, **kw)
    assert (kind == "supported") == ok, reason
    assert why in reason
    if not ok:
        with pytest.raises(ValueError, match="no kernel tiling"):
            K.fused_gemm(torch.zeros(mnk[0], mnk[2]),
                         torch.zeros(mnk[2], mnk[1]), **kw)
