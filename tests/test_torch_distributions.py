"""``layers.distributions`` of the port (``Uniform``, ``Normal``,
``Categorical``) against the JAX package's, on the CPU.

Both packages build the same ``to_dict()``; ``log_prob``, ``entropy`` and
``kl_divergence`` agree on the same parameters (f32 rtol 1e-5, atol
1e-6), and so do their gradients with respect to the parameters. The
samples draw from the port's own generator (the bits differ from
``jax.random``'s): held by their moments and support, and repeated under
a seed.
"""
import numpy as np
import pytest

import paddle_tpu_torch as tfluid

from test_torch_lod import PKGS, build_both, normalized
from test_torch_sequence_ops import f32

RTOL, ATOL = 1e-5, 1e-6
B, D, V = 4, 6, 9


def dist_net(fl):
    L = fl.layers
    Dn = L.distributions
    loc = L.data("loc", shape=[D], dtype="float32")
    scale = L.data("scale", shape=[D], dtype="float32")
    loc2 = L.data("loc2", shape=[D], dtype="float32")
    scale2 = L.data("scale2", shape=[D], dtype="float32")
    value = L.data("value", shape=[D], dtype="float32")
    for v in (loc, scale, loc2, scale2):
        v.stop_gradient = False
    n1, n2 = Dn.Normal(loc, scale), Dn.Normal(loc2, scale2)
    lo = L.data("lo", shape=[D], dtype="float32")
    hi = L.data("hi", shape=[D], dtype="float32")
    u = Dn.Uniform(lo, hi)
    uc = Dn.Uniform(0.5, 2.5)          # constants become assigned vars
    logits = L.data("logits", shape=[V], dtype="float32")
    logits2 = L.data("logits2", shape=[V], dtype="float32")
    logits.stop_gradient = False
    ids = L.data("ids", shape=[1], dtype="int64")
    c1, c2 = Dn.Categorical(logits), Dn.Categorical(logits2)
    outs = [n1.log_prob(value), n1.entropy(), n1.kl_divergence(n2),
            u.log_prob(value), u.entropy(), uc.entropy(),
            c1.entropy(), c1.log_prob(ids), c1.kl_divergence(c2)]
    total = L.sums([L.reduce_sum(o) for o in
                    (outs[0], outs[1], outs[2], outs[6], outs[7], outs[8])])
    grads = fl.gradients([total], [loc, scale, loc2, scale2, logits])
    return {"outs": outs, "grads": grads}


def dist_feed(seed=0):
    rng = np.random.RandomState(seed)
    lo = rng.randn(B, D).astype(np.float32)
    return {"loc": f32(B, D, seed=seed + 1),
            "scale": (rng.rand(B, D) + 0.5).astype(np.float32),
            "loc2": f32(B, D, seed=seed + 2),
            "scale2": (rng.rand(B, D) + 0.5).astype(np.float32),
            # half the values inside [lo, hi), half outside
            "value": (lo + rng.rand(B, D) * 3 - 0.5).astype(np.float32),
            "lo": lo, "hi": (lo + 2.0).astype(np.float32),
            "logits": f32(B, V, seed=seed + 3, scale=2.0),
            "logits2": f32(B, V, seed=seed + 4),
            "ids": rng.randint(0, V, (B, 1)).astype(np.int64)}


@pytest.fixture(scope="module")
def built():
    return build_both(dist_net)


def test_distributions_build_the_jax_programs(built):
    for k in (0, 1):
        assert normalized(built["torch"][k]) == normalized(built["jax"][k])


def test_distributions_compute_the_jax_values_and_grads(built):
    feed = dist_feed()
    res = {}
    for pkg, (fl, _) in PKGS.items():
        main, _, r = built[pkg]
        fetch = [v.name for v in r["outs"] + r["grads"]]
        res[pkg] = fl.Executor(fl.CPUPlace()).run(
            main, feed=feed, fetch_list=fetch, scope=fl.Scope())
    for i, (a, b) in enumerate(zip(res["torch"], res["jax"])):
        b = np.asarray(b)
        assert a.shape == b.shape, i
        # log(0) outside the uniform's support: -inf in both
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL,
                                   err_msg=str(i))
    assert np.isneginf(res["torch"][3]).any()


def sample_program(seed, n=20000):
    with tfluid.unique_name.guard():
        main, startup = tfluid.Program(), tfluid.Program()
        with tfluid.program_guard(main, startup):
            Dn = tfluid.layers.distributions
            loc = np.array([1.5, -2.0, 0.0], np.float32)
            scale = np.array([0.5, 2.0, 1.0], np.float32)
            ns = Dn.Normal(loc, scale).sample([n, 3], seed=seed)
            us = Dn.Uniform(np.array([-1.0, 2.0, 0.0], np.float32),
                            np.array([1.0, 5.0, 0.5], np.float32)) \
                .sample([n, 3], seed=seed + 1)
    return main, [ns, us]


def run_samples(seed):
    main, fetch = sample_program(seed)
    return tfluid.Executor(tfluid.CPUPlace()).run(
        main, fetch_list=fetch, scope=tfluid.Scope())


def test_samples_have_the_moments_and_support_and_repeat():
    ns, us = run_samples(7)
    n = ns.shape[0]
    # 5 standard errors of the mean and of the variance
    sd = np.array([0.5, 2.0, 1.0])
    assert (np.abs(ns.mean(0) - [1.5, -2.0, 0.0]) <= 5 * sd / np.sqrt(n)) \
        .all()
    assert (np.abs(ns.std(0) / sd - 1) <= 5 * np.sqrt(0.5 / n)).all()
    lo, hi = np.array([-1.0, 2.0, 0.0]), np.array([1.0, 5.0, 0.5])
    assert ((us >= lo) & (us < hi)).all()
    assert (np.abs(us.mean(0) - (lo + hi) / 2)
            <= 5 * (hi - lo) / np.sqrt(12 * n)).all()
    again = run_samples(7)
    np.testing.assert_array_equal(again[0], ns)
    np.testing.assert_array_equal(again[1], us)
    assert not np.array_equal(run_samples(8)[0], ns)
