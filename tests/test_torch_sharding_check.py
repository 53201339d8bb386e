"""The port's static sharding analysis (``analysis/sharding_check.py``,
PT730-PT744) against the JAX package's, on the programs of
``tests/test_sharding_check.py``: each program is built by that file's own
builders once with each package (its module globals swapped for the
port's), and ``propagate_sharding`` must give the same findings (code and
message, so the var names), the same collective events and the same
propagated specs. Pure metadata: exact equality, no tolerance."""
import contextlib

import pytest

import paddle_tpu as jfluid
import paddle_tpu.unique_name as jun
from paddle_tpu.analysis.sharding_check import \
    propagate_sharding as j_propagate

import paddle_tpu_torch as tfluid
import paddle_tpu_torch.unique_name as tun
from paddle_tpu_torch.analysis import default_pass_manager
from paddle_tpu_torch.analysis.sharding_check import \
    propagate_sharding as t_propagate

import test_sharding_check as J


@contextlib.contextmanager
def _port_globals():
    saved = J.fluid, J.un
    J.fluid, J.un = tfluid, tun
    try:
        yield
    finally:
        J.fluid, J.un = saved


def _both(build):
    j = build()
    with _port_globals():
        t = build()
    return j, t


def _summary(an):
    return ([(d.code, d.message, d.op_type) for d in an.diagnostics],
            [c.to_dict() for c in an.collectives],
            {n: tuple(s) for n, s in an.var_specs.items()},
            dict(an.param_specs))


def _liveness(fluid_is_port, program):
    if fluid_is_port:
        from paddle_tpu_torch.analysis.liveness import _donation_analysis
    else:
        from paddle_tpu.analysis.liveness import _donation_analysis
    cands, unsafe, _ = _donation_analysis(program.global_block, [], [])
    return {"cands": cands, "unsafe": unsafe}


def _fc_loss():
    main, y, loss = J._fc_loss_program()
    return main


def _shape_prog():
    with J.un.guard():
        main = J.fluid.Program()
        with J.fluid.program_guard(main, J.fluid.Program()):
            x = J.fluid.layers.data("x", shape=[4], dtype="float32")
            gb = main.global_block
            gb.create_var(name="shp", shape=(2,), dtype="int64")
            gb.append_op("shape", {"Input": x.name}, {"Out": "shp"})
    return main


CASES = {
    # name: (builder -> program or (program, specs), mesh, run kwargs)
    "PT730": (lambda: J._param_program(("w", (8, 4))), {"dp": 2},
              dict(specs={"w": ("tp",)})),
    "PT731": (lambda: J._param_program(("w", (8, 4))), {"dp": 2},
              dict(specs={"w": ("dp", None, None)})),
    "PT732": (lambda: J._param_program(("w", (8, 4))), {"dp": 2},
              dict(specs={"w": ("dp", "dp")})),
    "PT733": (lambda: J._param_program(("w", (10, 4))), {"dp": 4},
              dict(specs={"w": ("dp",)})),
    "PT734": (lambda: J._add_program(("dp",), ("tp",)),
              {"dp": 2, "tp": 2}, {}),
    "PT735": (lambda: J._matmul_program((None, "dp"), ("tp", None)),
              {"dp": 2, "tp": 2}, {}),
    "PT736": (J._reshape_fold_program, {"dp": 8},
              dict(batch=64, large_bytes=1024)),
    "PT737_PT741": (lambda: J._state_reshard_program(()), {"dp": 2},
                    dict(liveness=True)),
    "PT738": (lambda: J._sgd_program(("dp",)), {"dp": 2}, {}),
    "PT739": (lambda: J._momentum_program((None, "dp")), {"dp": 2}, {}),
    "PT740": (lambda: J._momentum_program(("dp",)), {"dp": 2}, {}),
    "PT742": (_fc_loss, {"dp": 8}, dict(feed_spec=(), batch=16)),
    "PT743": (_fc_loss, {"dp": 8}, dict(fetch="y", batch=16)),
    "PT744": (_shape_prog, {"dp": 8}, dict(batch=16)),
    "clean_fc": (_fc_loss, {"dp": 8}, dict(batch=16)),
}


def _run(which, built, mesh, kw):
    prog, specs = built if isinstance(built, tuple) else (built, None)
    specs = kw.get("specs", specs)
    propagate = t_propagate if which == "port" else j_propagate
    extra = {}
    if kw.get("liveness"):
        extra["liveness_info"] = _liveness(which == "port", prog)
    if "large_bytes" in kw:
        extra["large_bytes"] = kw["large_bytes"]
    fetches = ()
    if kw.get("fetch") == "y":
        fetches = [next(op.output("Out")[0] for op in
                        prog.global_block.ops if op.type in ("mul", "fc",
                                                             "elementwise_add"))]
    return propagate(prog, mesh, param_specs=specs,
                     feed_spec=kw.get("feed_spec"), fetch_names=fetches,
                     batch_size=kw.get("batch", 8), **extra)


@pytest.mark.parametrize("case", sorted(CASES))
def test_findings_equal_the_jax_analysis(case):
    build, mesh, kw = CASES[case]
    j, t = _both(build)
    ja, ta = _run("jax", j, mesh, kw), _run("port", t, mesh, kw)
    assert _summary(ta) == _summary(ja)
    code = case.split("_")[0]
    if code.startswith("PT"):
        assert code in {d.code for d in ta.diagnostics}


@pytest.mark.parametrize("zero", [False, True])
@pytest.mark.parametrize("model", ["bert_tiny", "deepfm", "mnist_mlp"])
def test_model_programs_equal_the_jax_analysis(model, zero):
    from paddle_tpu import models as jm
    from paddle_tpu.parallel.sharding import extract_param_specs as jx

    from paddle_tpu_torch import models as tm
    from paddle_tpu_torch.parallel.sharding import extract_param_specs as tx

    def build(m):
        if model == "bert_tiny":
            return m.build_bert_pretrain(m.BertConfig.tiny(), seq_len=32)
        if model == "deepfm":
            return m.build_deepfm()
        return m.build_mnist_mlp(hidden=(32,), optimizer="adam")

    with jun.guard():
        j = build(jm)
    with tun.guard():
        t = build(tm)
    mesh = {"dp": 8}
    ja = j_propagate(j["main"], mesh,
                     param_specs=jx(j["main"], mesh, zero=zero)[0],
                     fetch_names=[j["loss"].name], batch_size=64)
    ta = t_propagate(t["main"], mesh,
                     param_specs=tx(t["main"], mesh, zero=zero)[0],
                     fetch_names=[t["loss"].name], batch_size=64)
    js, ts = _summary(ja), _summary(ta)
    if model == "deepfm":
        # the port's rule for a reduction over listed dims (the field sums)
        # keeps the batch axis: the JAX rule's all-reduces over dp there,
        # which GSPMD never runs, are gone, and the values downstream stay
        # batch-sharded (the module docstring of the port's analysis)
        ops = t["main"].global_block.ops
        gone = [c for c in js[1] if c not in ts[1]]
        assert gone and all(
            ops[c["op"]].type == "reduce_sum" and c["axis"] == "dp"
            and 0 not in ops[c["op"]].attrs["dim"] for c in gone)
        assert [c for c in ts[1] if c not in js[1]] == []
        for n, sp in js[2].items():
            if ts[2][n] != sp:
                assert ts[2][n] == ("dp",) + tuple(sp[1:]) and sp[0] is None
        js = (js[0], [c for c in js[1] if c not in gone], ts[2], js[3])
    assert ts == js


def test_registered_pass_requires_liveness_and_noop_without_mesh():
    from paddle_tpu_torch.analysis import get_pass_registry

    assert get_pass_registry().get("sharding_check").requires == \
        ("liveness",)
    main = _both(_fc_loss)[1]
    pm = default_pass_manager()
    res = pm.run_pipeline(main, ("sharding_check",), verify="none")
    assert res.values.get("sharding_check") is None
    res = pm.run_pipeline(main, ("sharding_check",), verify="none",
                          options={"mesh": {"dp": 2}, "zero": True},
                          batch_size=4)
    an = res.values["sharding_check"]
    assert an is not None and an.mesh == {"dp": 2}
