"""``dataset`` in the PyTorch port against the JAX package's, on the CPU.

With the data cache pointed at an empty directory (``DATA_HOME`` of both
packages' ``dataset.common``, and ``$PADDLE_TPU_DATA_HOME``), each of the
12 loaders synthesises its data from fixed seeds; the first samples of
each equal the JAX package's exactly: values, dtypes and shapes, field by
field. The dictionaries and metadata helpers beside the readers are
equal too."""
import importlib

import numpy as np
import pytest

N_SAMPLES = 4

# loader -> (the reader factory's name, its arguments)
LOADERS = {
    "cifar": [("train10", ()), ("test10", ()), ("train100", ())],
    "conll05": [("train", ()), ("test", ())],
    "flowers": [("train", ()), ("test", ()), ("valid", ())],
    "imdb": [("train", ()), ("test", ())],
    "imikolov": [("train", ("dict", 5)), ("test", ("dict", 3))],
    "mnist": [("train", ()), ("test", ())],
    "movielens": [("train", ()), ("test", ())],
    "sentiment": [("train", ()), ("test", ())],
    "uci_housing": [("train", ()), ("test", ())],
    "voc2012": [("train", ()), ("test", ()), ("val", ())],
    "wmt14": [("train", ()), ("test", ())],
    "wmt16": [("train", ()), ("test", ())],
}
HELPERS = {
    "conll05": ("get_dict", "word_dict_len", "label_dict_len",
                "predicate_dict_len", "num_chunk_types", "get_embedding"),
    "imdb": ("word_dict",),
    "imikolov": ("build_dict",),
    "movielens": ("max_user_id", "max_movie_id", "max_job_id",
                  "categories_dict_size", "title_dict_size", "user_info",
                  "movie_info"),
    "sentiment": ("get_word_dict",),
    "wmt14": ("get_dict",),
    "wmt16": ("get_dict",),
}


@pytest.fixture
def empty_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_DATA_HOME", str(tmp_path))
    for pkg in ("paddle_tpu", "paddle_tpu_torch"):
        common = importlib.import_module(pkg + ".dataset.common")
        monkeypatch.setattr(common, "DATA_HOME", str(tmp_path))
    return tmp_path


def _mods(name):
    return (importlib.import_module("paddle_tpu.dataset." + name),
            importlib.import_module("paddle_tpu_torch.dataset." + name))


def _equal(a, b, where):
    if isinstance(a, (tuple, list)) and not isinstance(a, np.ndarray):
        assert type(a) is type(b) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _equal(x, y, f"{where}[{i}]")
        return
    if isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _equal(a[k], b[k], f"{where}[{k!r}]")
        return
    assert type(a) is type(b), (where, type(a), type(b))
    if isinstance(a, (np.ndarray, np.generic)):
        assert a.dtype == b.dtype and np.shape(a) == np.shape(b), where
        np.testing.assert_array_equal(a, b, err_msg=where)
    else:
        assert a == b, where


@pytest.mark.parametrize("name", sorted(LOADERS))
def test_first_samples_equal_the_jax_package(name, empty_cache):
    jmod, tmod = _mods(name)
    for factory, args in LOADERS[name]:
        if args and args[0] == "dict":
            jargs = (jmod.build_dict(),) + args[1:]
            targs = (tmod.build_dict(),) + args[1:]
        else:
            jargs = targs = args
        jr = getattr(jmod, factory)(*jargs)()
        tr = getattr(tmod, factory)(*targs)()
        for i in range(N_SAMPLES):
            _equal(next(jr), next(tr), f"{name}.{factory}()[{i}]")


@pytest.mark.parametrize("name", sorted(HELPERS))
def test_dictionaries_and_metadata_equal_the_jax_package(name,
                                                         empty_cache):
    jmod, tmod = _mods(name)
    for helper in HELPERS[name]:
        _equal(getattr(jmod, helper)(), getattr(tmod, helper)(),
               f"{name}.{helper}()")


def test_the_twelve_loaders_are_exported(empty_cache):
    import paddle_tpu.dataset as jd
    import paddle_tpu_torch.dataset as td

    assert sorted(td.__all__) == sorted(jd.__all__) == sorted(LOADERS)
