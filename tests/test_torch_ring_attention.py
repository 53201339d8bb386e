"""The port's ring attention (sequence parallelism) against the JAX
package's, on the CPU (the counterpart of ``tests/test_ring_attention.py``).

The port's ranks are gloo processes (``torch_dist_runner``): two ranks on
``{"sp": 2}`` and four on ``{"dp": 2, "sp": 2}``. On the CPU each block
is the plain version of K1 (and of K3/K4 in the backward), with the same
offsets and lse combine the kernels get on the card.

* ``ring_attention`` at sp = 2, causal and not: the output and the
  gradients of sum(o * w) on every rank against the JAX package's
  ``ring_attention`` on a two-device ``sp`` mesh and against its dense
  ``attention_reference``, at rtol 2e-5 / atol 2e-6 (float32; the JAX
  test's own tolerance for the value, 5e-5 / 5e-6 for the gradients).
* The Fluid-API program of ``__graft_entry__._dryrun_ring_attention_fluid_api``
  (``fused_multihead_attention(sequence_parallel=True)`` under
  ``CompiledProgram``) trains three SGD steps; its losses equal the JAX
  package's ring run on the same mesh shape and its plain run at rtol
  2e-5 / atol 1e-6 (the JAX dryrun's own gate is 2e-4).
* The refusals (``BiasQK``, ``attn_dropout > 0``) carry the JAX package's
  messages.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu.unique_name as jun
from paddle_tpu.parallel.ring_attention import attention_reference as j_dense
from paddle_tpu.parallel.ring_attention import ring_attention as j_ring
from paddle_tpu.parallel.sharding import make_mesh

import torch_dist_runner as R

VALUE_TOL = dict(rtol=2e-5, atol=2e-6)
GRAD_TOL = dict(rtol=5e-5, atol=5e-6)
LOSS_TOL = dict(rtol=2e-5, atol=1e-6)


@pytest.fixture(scope="module")
def jax_ring():
    """The JAX package's ring and dense attention, value and gradients of
    sum(o * w), each traced once under ``jax.jit``."""
    q, k, v, w = (jnp.asarray(a) for a in R.ring_inputs())
    mesh = make_mesh({"sp": 2})
    out = {}
    for causal in (False, True):
        tag = "causal" if causal else "full"

        def loss(q_, k_, v_, fn):
            return (fn(q_, k_, v_) * w).sum()

        ring = lambda a, b, c: j_ring(a, b, c, mesh, causal=causal)  # noqa
        dense = lambda a, b, c: j_dense(a, b, c, causal=causal)  # noqa
        out[f"{tag}/o"] = np.asarray(jax.jit(ring)(q, k, v))
        out[f"{tag}/dense"] = np.asarray(jax.jit(dense)(q, k, v))
        g = jax.jit(jax.grad(lambda a, b, c: loss(a, b, c, ring),
                             argnums=(0, 1, 2)))(q, k, v)
        gd = jax.jit(jax.grad(lambda a, b, c: loss(a, b, c, dense),
                              argnums=(0, 1, 2)))(q, k, v)
        for n, a, b in zip("qkv", g, gd):
            out[f"{tag}/d{n}"] = np.asarray(a)
            out[f"{tag}/dense_d{n}"] = np.asarray(b)
    return out


def _jax_fluid(mesh_shape, seq_par, steps=3):
    dp, sp = mesh_shape.get("dp", 1), mesh_shape.get("sp", 1)
    B, H, S, D = 2 * dp, 2, 4 * sp, 8
    exe, scope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    with jun.guard():
        main, startup, loss = R.build_ring_fluid(jfluid, seq_par, B, H, S,
                                                 D)
    prog = main if not seq_par else jfluid.CompiledProgram(
        main).with_data_parallel(loss_name=loss.name,
                                 places=make_mesh(mesh_shape))
    with jfluid.scope_guard(scope):
        exe.run(startup)
        scope.set_var("wq", np.eye(D, dtype=np.float32))
        feed = R.ring_fluid_feeds(B, H, S, D)
        return np.array([float(np.asarray(exe.run(
            prog, feed=feed, fetch_list=[loss.name])[0]).reshape(-1)[0])
            for _ in range(steps)])


def _jax_refusal(what):
    B, H, S, D = 2, 2, 8, 8
    exe, scope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    kw = dict(bias=True) if what == "bias" else dict(dropout=0.1)
    with jun.guard():
        main, startup, loss = R.build_ring_fluid(jfluid, True, B, H, S, D,
                                                 **kw)
    feed = R.ring_fluid_feeds(B, H, S, D)
    if what == "bias":
        feed["m"] = np.zeros((B, S), np.float32)
    prog = jfluid.CompiledProgram(main).with_data_parallel(
        loss_name=loss.name, places=make_mesh({"dp": 1, "sp": 2}))
    with jfluid.scope_guard(scope):
        exe.run(startup)
        with pytest.raises(Exception) as err:
            exe.run(prog, feed=feed, fetch_list=[loss.name])
    # both packages wrap an op's error naming the op; the refusal itself
    # is the NotImplementedError's message
    msg = str(err.value)
    assert "NotImplementedError: " in msg, msg
    return msg.split("NotImplementedError: ", 1)[1]


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    out2 = tmp_path_factory.mktemp("ring2")
    out4 = tmp_path_factory.mktemp("ring4")
    rc, logs = R.launch(out2, ["ring_fn", "ring_fluid", "ring_refusals"],
                        nproc=2, timeout=300)
    assert rc == 0, logs
    rc, logs = R.launch(out4, ["ring_fluid_dpsp"], nproc=4, timeout=300)
    assert rc == 0, logs
    return R.results(out2, 2), R.results(out4, 4)


@pytest.mark.parametrize("causal", ["full", "causal"])
def test_ring_matches_jax_ring_value_and_gradients(launched, jax_ring,
                                                   causal):
    ranks, _ = launched
    ref = jax_ring
    for r in ranks:
        np.testing.assert_allclose(r[f"ring_fn/{causal}/o"],
                                   ref[f"{causal}/o"], **VALUE_TOL)
        np.testing.assert_allclose(r[f"ring_fn/{causal}/o"],
                                   ref[f"{causal}/dense"], **VALUE_TOL)
        for n in "qkv":
            np.testing.assert_allclose(r[f"ring_fn/{causal}/d{n}"],
                                       ref[f"{causal}/d{n}"], err_msg=n,
                                       **GRAD_TOL)
            np.testing.assert_allclose(r[f"ring_fn/{causal}/d{n}"],
                                       ref[f"{causal}/dense_d{n}"],
                                       err_msg=n, **GRAD_TOL)


def test_fluid_api_sequence_parallel_matches_jax(launched):
    ranks, _ = launched
    ring = _jax_fluid({"dp": 1, "sp": 2}, True)
    plain = _jax_fluid({"dp": 1, "sp": 2}, False)
    for r in ranks:
        np.testing.assert_allclose(r["ring_fluid/losses"], ring, **LOSS_TOL)
        np.testing.assert_allclose(r["ring_fluid/losses"], plain,
                                   **LOSS_TOL)
    assert ranks[0]["ring_fluid/losses"][-1] < ranks[0][
        "ring_fluid/losses"][0]
    np.testing.assert_array_equal(ranks[0]["ring_fluid/wq"],
                                  ranks[1]["ring_fluid/wq"])


def test_fluid_api_on_dp_sp_mesh_matches_jax(launched):
    _, ranks = launched
    ring = _jax_fluid({"dp": 2, "sp": 2}, True)
    for r in ranks:
        np.testing.assert_allclose(r["ring_fluid_dpsp/losses"], ring,
                                   **LOSS_TOL)


@pytest.mark.parametrize("what", ["bias", "dropout"])
def test_refusals_carry_the_jax_messages(launched, what):
    ranks, _ = launched
    want = _jax_refusal(what)
    for r in ranks:
        got = str(r[f"ring_refusals/{what}"][0])
        assert "NotImplementedError" in got and want in got, (got, want)


def test_ring_holds_no_gathered_kv_or_score_matrix():
    """One process, a stubbed two-rank ring: every block product the body
    runs is [B*H, T/2, T/2], and the exchanged blocks are T/2 long."""
    import torch

    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.parallel import ring_attention as ra
    from paddle_tpu_torch.parallel.sharding import Mesh

    seen, sent = [], []
    real = ra._block_fn

    def spy(use_flash):
        fn = real(use_flash)

        def block(q, k, v, **kw):
            seen.append((tuple(q.shape), tuple(k.shape)))
            return fn(q, k, v, **kw)
        return block

    def exchange(t, group, ranks, shift=1):
        sent.append(tuple(t.shape))
        return t
    q, k, v, _ = (torch.from_numpy(a) for a in R.ring_inputs())
    saved = (ra._block_fn, dist._ring_exchange, dist.axis_group,
             dist.get_rank)
    ra._block_fn, dist._ring_exchange = spy, exchange
    dist.axis_group = lambda mesh, axis: (None, [0, 1])
    dist.get_rank = lambda: 0
    try:
        Tl = R.RING["T"] // 2
        ra.ring_attention_local(q[:, :Tl], k[:, :Tl], v[:, :Tl], "sp",
                                causal=True, mesh=Mesh({"sp": 2}))
    finally:
        (ra._block_fn, dist._ring_exchange, dist.axis_group,
         dist.get_rank) = saved
    BH = R.RING["B"] * R.RING["H"]
    assert seen == [((BH, Tl, R.RING["D"]), (BH, Tl, R.RING["D"]))] * 2
    assert sent == [(BH, Tl, R.RING["D"])] * 2


def test_combine_keeps_dead_rows_dead_and_finite_gradients():
    import torch

    from paddle_tpu_torch.parallel.ring_attention import _combine

    o = torch.randn(2, 3, 4, requires_grad=True)
    lse = torch.tensor([[0.5, -float("inf"), 1.0]] * 2, requires_grad=True)
    o_s = torch.randn(2, 3, 4, requires_grad=True)
    lse_s = torch.tensor([[-float("inf"), -float("inf"), 0.0]] * 2,
                         requires_grad=True)
    out, l = _combine(o, lse, o_s, lse_s)
    assert torch.isinf(l[:, 1]).all() and (out[:, 1] == 0).all()
    torch.testing.assert_close(out[:, 0], o[:, 0].detach())
    (out.sum() + l[:, [0, 2]].sum()).backward()
    for t in (o, lse, o_s, lse_s):
        assert torch.isfinite(t.grad).all()
