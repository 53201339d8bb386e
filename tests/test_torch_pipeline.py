"""The port's pipeline parallelism (``layers.PipelineRegion``, the
``pipeline`` op, ``parallel/pipeline.py``'s GPipe schedule) against the
JAX package's, on the CPU (the counterpart of ``tests/test_pipeline.py``'s
region cases and ``__graft_entry__._dryrun_pipeline``).

The region model of ``tests/test_pipeline.py`` (D 16, tanh stages, SGD
0.1, four microbatches, eight rows, the JAX test's weights): the port's
ranks are gloo processes (``torch_dist_runner``, one launch of two ranks
for ``{"pp": 2}`` and one of four for ``{"pp": 4}`` and ``{"dp": 2,
"pp": 2}``); the reference is the JAX package's scan path on one process,
as the JAX test holds its GPipe schedule. Tolerances, float32:

* the four losses and the stacked parameters after them: rtol 2e-5 (the
  JAX test's), atol 1e-6; the port's scan path against the JAX one's at
  the same rtol (the microbatches and the scan sum in other orders);
* BERT's block as the stage (hidden 64, 2 heads, seq 16, two stages of
  one block, two microbatches, Adam): the port's scan path against the
  JAX package's, losses at rtol 1e-5; the port's ``pp`` ranks against the
  port's scan path, losses at rtol 1e-5 and the parameters after three
  steps at rtol 1e-4 / atol 1e-6 (Adam's normalised step amplifies the
  last bits of tiny gradients).

The negative controls: the output's cotangent pulled back on every stage
misses the loss gate; the input's cotangent left on stage 0 parts the
replicas of an fc before the region, which the replica check names.
"""
import os
import sys

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu_torch.analysis.sharding_check import propagate_sharding
from paddle_tpu_torch.ops import pipeline_op
from paddle_tpu_torch.parallel import pipeline as tpl
from paddle_tpu_torch.parallel import sharding as tsh

import torch_dist_runner as R

sys.path.insert(0, os.path.join(R.REPO, "tools"))
import torch_mp_worker as W  # noqa: E402

LOSS_TOL = dict(rtol=2e-5, atol=1e-6)
ATTN_LOSS_RTOL = 1e-5
ATTN_PARAM_TOL = dict(rtol=1e-4, atol=1e-6)


def _scan(fluid, P, steps=R.PP_STEPS):
    """One process, no mesh: the pipeline op's scan path. The losses and
    the stacked parameters after them."""
    main, startup, loss = R.build_region(fluid, P)
    exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    exe.run(startup, scope=scope)
    init = R.region_init(P)
    for n in list(scope.vars):
        for k in ("w", "b"):
            if n.endswith(f".{k}.pp_stacked"):
                scope.set_var(n, init[k] if fluid is jfluid
                              else torch.from_numpy(init[k].copy()))
    feed = {n: init[n] for n in ("x", "y")}
    losses = [float(np.asarray(exe.run(main, feed=feed, fetch_list=[
        loss.name], scope=scope)[0]).reshape(-1)[0]) for _ in range(steps)]
    params = {k: np.asarray(scope.numpy(f"pipeline_0.{k}.pp_stacked"))
              for k in ("w", "b")}
    return np.array(losses), params


@pytest.fixture(scope="module")
def jax_scan():
    return {P: _scan(jfluid, P) for P in (2, 4)}


def _attn_scan(fluid, init=None):
    main, startup, loss = W.build_pipeline_encoder(fluid, **R.PP_ATTN)
    exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    if init is None:
        exe.run(startup, scope=scope)
        init = {n: np.asarray(scope.numpy(n)) for n in scope.vars}
    else:
        for n, v in init.items():
            scope.set_var(n, v if fluid is jfluid
                          else torch.from_numpy(v.copy()))
    feed = W.pipeline_feed(0, R.PP_ATTN_BATCH, R.PP_ATTN["seq"],
                           R.PP_ATTN["vocab"])
    losses = [float(np.asarray(exe.run(main, feed=feed, fetch_list=[
        loss.name], scope=scope)[0]).reshape(-1)[0])
        for _ in range(R.PP_ATTN_STEPS)]
    params = {p.name: np.asarray(scope.numpy(p.name))
              for p in main.all_parameters()}
    return init, np.array(losses), params


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    init, losses, params = _attn_scan(tfluid)
    out2 = tmp_path_factory.mktemp("pp2")
    out4 = tmp_path_factory.mktemp("pp4")
    np.savez(out2 / "init_pp_attn.npz", **init)
    # the negative controls patch the schedule in their rank processes:
    # last in a launch
    rc, logs = R.launch(out2, ["pp2", "pp_attn", "pp_fn",
                               "pp_dout_everywhere"], nproc=2, timeout=400)
    assert rc == 0, logs
    rc, logs = R.launch(out4, ["pp4", "dppp", "dppp_fc",
                               "dppp_no_broadcast"], nproc=4, timeout=500)
    assert rc == 0, logs
    return {"pp2": R.results(out2, 2), "pp4": R.results(out4, 4),
            "attn_scan": (init, losses, params)}


def _gate(res, case, ref):
    losses, params = ref
    np.testing.assert_allclose(res[f"{case}/losses"], losses, **LOSS_TOL)
    for k in ("w", "b"):
        np.testing.assert_allclose(res[f"{case}/param/{k}"], params[k],
                                   err_msg=k, **LOSS_TOL)


@pytest.mark.parametrize("P", [2, 4])
def test_port_scan_path_equals_the_jax_scan_path(jax_scan, P):
    losses, params = _scan(tfluid, P)
    np.testing.assert_allclose(losses, jax_scan[P][0], **LOSS_TOL)
    for k in ("w", "b"):
        np.testing.assert_allclose(params[k], jax_scan[P][1][k],
                                   err_msg=k, **LOSS_TOL)
    assert losses[-1] < losses[0]


@pytest.mark.parametrize("launch, case, P, nproc", [
    ("pp2", "pp2", 2, 2), ("pp4", "pp4", 4, 4), ("pp4", "dppp", 2, 4)])
def test_gpipe_ranks_match_the_jax_scan_path(launched, jax_scan, launch,
                                             case, P, nproc):
    ranks = launched[launch]
    assert len(ranks) == nproc
    for r in ranks:
        _gate(r, case, jax_scan[P])
    # every rank gathers the same stacked parameters
    for r in ranks[1:]:
        np.testing.assert_array_equal(r[f"{case}/param/w"],
                                      ranks[0][f"{case}/param/w"])


def test_each_rank_holds_its_stage_slice(launched):
    """The stacked parameters' bytes on a rank: one stage's of P."""
    whole = (R.PP_D * R.PP_D + R.PP_D) * 4
    for launch, case, P in (("pp2", "pp2", 2), ("pp4", "pp4", 4),
                            ("pp4", "dppp", 2)):
        for r in launched[launch]:
            assert int(r[f"{case}/stacked_bytes"][0]) == whole


def test_attention_stage_scan_path_equals_the_jax_one(launched):
    init, losses, _ = launched["attn_scan"]
    _, jlosses, _ = _attn_scan(jfluid, init)
    np.testing.assert_allclose(losses, jlosses, rtol=ATTN_LOSS_RTOL)


def test_attention_stage_pp_ranks_match_the_scan_path(launched):
    _, losses, params = launched["attn_scan"]
    for r in launched["pp2"]:
        np.testing.assert_allclose(r["pp_attn/losses"], losses,
                                   rtol=ATTN_LOSS_RTOL)
        for n, v in params.items():
            np.testing.assert_allclose(r[f"pp_attn/param/{n}"], v,
                                       err_msg=n, **ATTN_PARAM_TOL)


def test_dp_pp_replicas_of_the_ops_before_the_region_stay_equal(launched):
    """An fc before the region under dp x pp, the replica check every
    step (policy raise): nothing diverges, and the ranks agree."""
    ranks = launched["pp4"]
    for r in ranks:
        assert str(r["dppp_fc/named"][0]) == ""
        np.testing.assert_array_equal(r["dppp_fc/losses"],
                                      ranks[0]["dppp_fc/losses"])


def test_output_cotangent_on_every_stage_fails_the_gate(launched,
                                                        jax_scan):
    """Negative control: each stage also pulls back the output's
    cotangent (the stacked gradients too large)."""
    with pytest.raises(AssertionError):
        _gate(launched["pp2"][0], "pp_dout_everywhere", jax_scan[2])


def test_input_cotangent_left_on_stage_0_parts_the_replicas(launched):
    """Negative control: without the broadcast of the input's cotangent
    the fc before the region updates differently on the pp ranks; the
    replica check raises naming it."""
    named = {str(r["dppp_no_broadcast/named"][0])
             for r in launched["pp4"]}
    assert named and all(n.startswith("pre_fc") for n in named), named


# -- single-process checks -------------------------------------------------

def test_region_refusals_match_the_jax_package():
    for fluid in (jfluid, tfluid):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.unique_name.guard(), fluid.program_guard(main, startup):
            x = fluid.layers.data("x", shape=[8], dtype="float32")
            pipe = fluid.layers.PipelineRegion(num_stages=2)
            with pytest.raises(ValueError, match="shape-preserving"):
                with pipe.stage(x) as s:
                    w = s.param("w", [8, 4])
                    s.set_output(fluid.layers.matmul(s.input, w))
            pipe = fluid.layers.PipelineRegion(num_stages=2)
            with pytest.raises(ValueError, match="set_output"):
                with pipe.stage(x) as s:
                    s.param("w", [8, 8])
        assert pipe.num_microbatches == 2


def test_region_program_desc_matches_the_jax_package():
    """The same op, inputs, attrs and stacked names in both packages."""
    descs = []
    for fluid in (jfluid, tfluid):
        main, _, _ = R.build_region(fluid, 4)
        op = next(o for o in main.global_block.ops if o.type == "pipeline")
        descs.append((dict(op.inputs), dict(op.outputs),
                      {k: v for k, v in op.attrs.items()
                       if not k.startswith("__") and k != "op_callstack"},
                      sorted(p.name for p in main.all_parameters())))
    assert descs[0] == descs[1]
    assert descs[1][3] == ["pipeline_0.b.pp_stacked",
                           "pipeline_0.w.pp_stacked"]


def test_mesh_takes_pp_and_refuses_it_beside_model_axes():
    tsh.check_mesh(tsh.Mesh({"dp": 2, "pp": 2}))
    for other in ("tp", "sp"):
        with pytest.raises(NotImplementedError, match="slice 28"):
            tsh.check_mesh(tsh.Mesh({"pp": 2, other: 2}))


def test_stage_count_and_microbatch_checks():
    mesh = tsh.Mesh({"dp": 2, "pp": 2})
    assert tpl.check_pipeline(2, 8, mesh, 4) == 2
    with pytest.raises(ValueError, match="must match"):
        tpl.check_pipeline(4, 8, mesh, 4)
    with pytest.raises(ValueError, match="per-dp-rank batch 6 not "
                                         "divisible by num_microbatches 4"):
        tpl.check_pipeline(2, 6, mesh, 4)

    class Op:
        attrs = {"num_stages": 4}

    class Ctx:
        mesh = tsh.Mesh({"pp": 2})

    with pytest.raises(ValueError, match="num_stages=4 but the mesh 'pp' "
                                         "axis has 2 ranks"):
        pipeline_op._pp_mesh(Ctx(), Op())
    Ctx.mesh = None
    assert pipeline_op._pp_mesh(Ctx(), Op()) is None


def test_pipeline_function_over_two_ranks(launched):
    """``parallel.pipeline.pipeline`` itself: the stages composed in
    order on every rank (rtol 1e-5: the microbatch rows and the whole
    batch meet the products in other orders)."""
    init = R.region_init(2)
    h = init["x"]
    for s in range(2):
        h = np.tanh(h @ init["w"][s] + init["b"][s])
    for r in launched["pp2"]:
        np.testing.assert_allclose(r["pp_fn/out"], h, rtol=1e-5,
                                   atol=1e-6)


def test_stack_stage_params():
    a = [torch.ones(2, 3), torch.zeros(3)]
    b = [torch.full((2, 3), 2.0), torch.ones(3)]
    w, bias = tpl.stack_stage_params([a, b])
    assert w.shape == (2, 2, 3) and bias.shape == (2, 3)
    assert float(w[1, 0, 0]) == 2.0
    d = tpl.stack_stage_params([{"w": a[0]}, {"w": b[0]}])
    assert d["w"].shape == (2, 2, 3)


def test_analysis_places_no_pp_collective_and_sums_stage_grads_over_dp():
    """The port's rule for the op: Out keeps X's spec, the stacked
    gradients keep their params' (pp) spec and get one all-reduce over
    dp each; nothing is recorded over pp."""
    main, _, loss = R.build_region(tfluid, 2)
    mesh = {"dp": 2, "pp": 2}
    specs, feed_spec = tsh.extract_param_specs(main, mesh)
    assert specs["pipeline_0.w.pp_stacked"] == ("pp",)
    an = propagate_sharding(main, mesh, param_specs=specs,
                            feed_spec=feed_spec, feed_names=["x", "y"],
                            fetch_names=[loss.name], batch_size=8)
    op = next(o for o in main.global_block.ops if o.type == "pipeline")
    assert an.var_specs[op.output("Out")[0]][0] == "dp"
    evs = [(e.kind, e.axis, e.var) for e in an.collectives]
    assert not [e for e in evs if "pp" in e[1]]
    for n in ("w", "b"):
        assert ("all_reduce", "dp", f"pipeline_0.{n}.pp_stacked@GRAD") \
            in evs
