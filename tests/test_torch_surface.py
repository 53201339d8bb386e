"""The public surface of the port against the JAX package's: for every
module of ``paddle_tpu_torch`` that has a counterpart in ``paddle_tpu``,
each name the JAX module exports (its ``__all__``, else its public names
defined in the package) exists in the port's module, as an attribute or
an importable submodule, unless ``STILL_MISSING`` lists it with the
reason it waits. The list shrinks slice by slice, as
``test_torch_lod.STILL_TO_PORT`` does; a name ported must leave it."""
import importlib
import importlib.util
import pkgutil
import types
import warnings

import pytest

import paddle_tpu_torch

NO_TPU = "TPU-only: the port runs on CUDAPlace/CPUPlace"

# module ('' is the package) -> {name: why it waits}
STILL_MISSING = {
    "": {
        "TPUPlace": NO_TPU,
    },
    "executor": {"TPUPlace": NO_TPU},
    "flags": {"xla_options": "FLAGS_xla_options is XLA's; the port keeps "
                             "no executable"},
    "kernels": {
        "supports_gemm": "the Pallas tiling predicate; the port's "
                         "kernels.fused_gemm.classify_gemm names each "
                         "Hopper constraint",
        "supports_shapes": "the Pallas tiling predicate; the port's "
                           "kernels.flash_attention classifies its own",
    },
    "layer_helper": {"init_mod": "an import alias of the initializer "
                                 "module, not an API"},
    "lowering": {"np_dtype": "the JAX side's dtype helper; the port's is "
                             "core.types.np_dtype"},
    "tuning": {"CPU_OPTION_SETS": "XLA option sets; the port tunes K5's "
                                  "block triple only",
               "TPU_OPTION_SETS": "XLA option sets; the port tunes K5's "
                                  "block triple only"},
}
# the names ROADMAP Queue A item 2 lists: each is ported now
ITEM_2 = {
    "": ("Variable", "Parameter", "Block", "Operator", "data",
         "scope_guard", "WeightNormParamAttr", "learning_rate_scheduler",
         "tuning", "op_registry", "memory_optimize", "release_memory",
         "name_scope", "in_dygraph_mode"),
    "layers": ("beam_search", "beam_search_decode", "dice_loss",
               "mse_loss", "npair_loss", "rank", "sum", "scatter_nd",
               "lstm_unit", "adaptive_pool2d", "autoincreased_step_counter",
               "math_op_patch", "merge_selected_rows",
               "get_tensor_from_selected_rows", "conv2d_transpose",
               "group_norm", "instance_norm", "l2_normalize", "prelu",
               "image_resize", "resize_bilinear", "resize_nearest"),
    "initializer": ("Initializer", "MSRA", "Bilinear",
                    "NumpyArrayInitializer", "ConstantInitializer",
                    "UniformInitializer", "NormalInitializer",
                    "TruncatedNormalInitializer", "XavierInitializer",
                    "MSRAInitializer", "BilinearInitializer"),
    "framework": ("name_scope", "switch_main_program",
                  "switch_startup_program", "in_dygraph_mode"),
    "unique_name": ("switch",),
    "resilience.retry": ("retrying",),
    "models": ("build_deepfm",),
}


def _public(mod, root):
    names = getattr(mod, "__all__", None)
    if names is not None:
        return set(names)
    out = set()
    for n in dir(mod):
        if n.startswith("_"):
            continue
        v = getattr(mod, n)
        where = v.__name__ if isinstance(v, types.ModuleType) \
            else getattr(v, "__module__", None)
        if where and (where == root or where.startswith(root + ".")):
            out.add(n)
    return out


def _present(mod, modname, name):
    if hasattr(mod, name):
        return True
    if not hasattr(mod, "__path__"):      # a module, not a package
        return False
    return importlib.util.find_spec(f"{modname}.{name}") is not None


def _pairs():
    names = [""] + sorted(m.name for m in pkgutil.walk_packages(
        paddle_tpu_torch.__path__, ""))
    out = []
    for name in names:
        suffix = "." + name if name else ""
        try:
            jmod = importlib.import_module("paddle_tpu" + suffix)
        except ImportError:
            continue
        out.append(name)
    return out


# the JAX package's ``incubate`` and ``parallel`` name their submodules
# only once something has imported them: import them all, so that what the
# comparison sees does not hang on which test file ran before in the same
# process
JAX_INCUBATE = ("paddle_tpu.incubate.data_generator",
                "paddle_tpu.incubate.fleet", "paddle_tpu.parallel.pipeline",
                "paddle_tpu.parallel.ring_attention")


@pytest.fixture(scope="module")
def missing():
    for name in JAX_INCUBATE:
        importlib.import_module(name)
    got = {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for name in _pairs():
            suffix = "." + name if name else ""
            tmod = importlib.import_module("paddle_tpu_torch" + suffix)
            jmod = importlib.import_module("paddle_tpu" + suffix)
            gone = {n for n in _public(jmod, "paddle_tpu")
                    if not _present(tmod, "paddle_tpu_torch" + suffix, n)}
            if gone:
                got[name] = gone
    return got


def test_every_missing_name_is_listed_with_its_reason(missing):
    for mod, names in missing.items():
        listed = set(STILL_MISSING.get(mod, {}))
        assert names <= listed, (mod, sorted(names - listed))


def test_the_list_holds_no_name_already_ported(missing):
    for mod, names in STILL_MISSING.items():
        assert set(names) <= missing.get(mod, set()), \
            (mod, sorted(set(names) - missing.get(mod, set())))
        assert all(names.values())
    assert sum(len(v) for v in STILL_MISSING.values()) == 9


@pytest.mark.parametrize("mod", sorted(ITEM_2))
def test_queue_a_item_2_names_are_ported(mod):
    m = importlib.import_module("paddle_tpu_torch" + ("." + mod if mod
                                                       else ""))
    for n in ITEM_2[mod]:
        assert hasattr(m, n), (mod, n)


def test_the_ported_helpers_behave_as_the_reference():
    import paddle_tpu_torch as tf
    from paddle_tpu_torch import unique_name

    old = unique_name.switch()
    try:
        assert unique_name.generate("x") == "x_0"
    finally:
        unique_name.switch(old)
    main, start = tf.Program(), tf.Program()
    prev = tf.framework.switch_main_program(main)
    try:
        assert tf.default_main_program() is main
        with tf.name_scope("outer"), tf.name_scope("inner"):
            v = tf.data("v", shape=[3], dtype="float32")
            o = tf.layers.scale(v, scale=2.0)
        op = main.global_block.ops[-1]
        assert op.attrs["op_namescope"] == "outer/inner"
        assert o.shape == (-1, 3)
    finally:
        tf.framework.switch_main_program(prev)
    assert not tf.in_dygraph_mode()
    with tf.dygraph.guard(tf.CPUPlace()):
        assert tf.in_dygraph_mode()
    scope = tf.Scope()
    with tf.scope_guard(scope):
        assert tf.global_scope() is scope
    assert tf.global_scope() is not scope
    with pytest.warns(UserWarning):
        assert tf.memory_optimize(main) is main
    with pytest.warns(UserWarning):
        assert tf.release_memory(main) is main
    assert tf.WeightNormParamAttr is tf.ParamAttr
    assert tf.op_registry.has_op("lookup_table")

    from paddle_tpu_torch.resilience.retry import retrying

    calls = []

    @retrying("device_put")
    def flaky():
        calls.append(1)
        if len(calls) < 2:
            raise ConnectionError("transient")
        return 7

    assert flaky() == 7 and len(calls) == 2
