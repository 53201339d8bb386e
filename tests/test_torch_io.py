"""``io`` and ``resilience.checkpoint`` in the PyTorch port, against the
JAX package on the CPU.

* Round trips of vars, params and persistables (one ``.npy`` per var and
  one ``npz``) and of the inference model, bit-exact; the files the port
  writes are byte-identical to the JAX package's for the same values
  (``manifest.json`` and every ``.npy``), bfloat16 included (descr
  ``<V2``, ``"bfloat16"`` in the manifest).
* The checkpoint cases of ``tests/test_resilience.py`` (manifest, tamper
  detection, PT600-PT604, a failed save, atomic replace, a file where the
  directory goes, a shape mismatch that leaves the scope untouched, the
  recovery walk past torn and legacy serials) and of
  ``tests/test_resume.py`` (resume past a torn serial, a tampered blob
  refused), run through the port. Its contrib ``Trainer`` and
  ``DataLoader`` are not in the port, so the recovery walk is driven
  through ``resilience.load_latest_checkpoint`` and the data cursor is a
  meta entry.
* Across packages, both directions: a checkpoint saved by one package
  loads in the other, and the next steps' fetches agree within the
  parity tolerances (f32 rtol 1e-5 / atol 1e-6; the bf16 AMP program's
  losses rtol 1e-3). The JAX package cannot load a bfloat16 blob itself
  (``jnp.asarray`` refuses numpy's ``V2``), so a bfloat16 var crosses
  from the JAX package to the port only."""
import json
import os

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu.unique_name as jun
from paddle_tpu import resilience as jres

import paddle_tpu_torch as tfluid
import paddle_tpu_torch.unique_name as tun
from paddle_tpu_torch import monitor as tmonitor
from paddle_tpu_torch import resilience
from paddle_tpu_torch.interop import scope_from_numpy
from paddle_tpu_torch.resilience import (CheckpointCorruptError,
                                         fault_plan_guard)

RTOL, ATOL = 1e-5, 1e-6
PKGS = {"jax": (jfluid, jun), "torch": (tfluid, tun)}


@pytest.fixture(autouse=True)
def _reset():
    from paddle_tpu import flags as jflags
    from paddle_tpu_torch import clip as tclip
    from paddle_tpu_torch import flags as tflags

    snaps = [(m, dict(m._overrides)) for m in (jflags, tflags)]
    tclip._clip_attr["__global__"] = None
    yield
    tclip._clip_attr["__global__"] = None
    for m, snap in snaps:
        m._overrides.clear()
        m._overrides.update(snap)


def _build(fl, width=1, amp=False):
    x = fl.layers.data("x", shape=[4], dtype="float32")
    y = fl.layers.data("y", shape=[width], dtype="float32")
    pred = fl.layers.fc(x, width)
    d = fl.layers.elementwise_sub(pred, y)
    loss = fl.layers.mean(fl.layers.elementwise_mul(d, d))
    opt = fl.optimizer.Adam(learning_rate=0.01)
    if amp:
        opt = fl.contrib.mixed_precision.decorate(opt)
    opt.minimize(loss)
    return loss


def _feed(batch=8, width=1, seed=0):
    rng = np.random.RandomState(seed)
    return {"x": rng.rand(batch, 4).astype(np.float32),
            "y": rng.rand(batch, width).astype(np.float32)}


class Session:
    """One package's built program, executor and initialized scope."""

    def __init__(self, pkg="torch", width=1, amp=False):
        fl, un = PKGS[pkg]
        self.fl = fl
        with un.guard():
            self.main, self.startup = fl.Program(), fl.Program()
            with fl.program_guard(self.main, self.startup):
                self.loss = _build(fl, width, amp)
        self.exe = fl.Executor(fl.CPUPlace())
        self.scope = fl.Scope()
        self.exe.run(self.startup, scope=self.scope)

    def run(self, feed):
        return self.exe.run(self.main, feed=feed, fetch_list=[self.loss],
                            scope=self.scope)

    def save(self, dirname, meta=None):
        self.fl.io.save_checkpoint(self.exe, dirname, self.main,
                                   scope=self.scope, meta=meta or {})

    def load(self, dirname, **kw):
        return self.fl.io.load_checkpoint(self.exe, dirname, self.main,
                                          scope=self.scope, **kw)

    def image(self):
        return {n: np.array(_host(self.scope.find_var(n)))
                for n in self.scope.vars}


def _host(v):
    if isinstance(v, torch.Tensor):
        if v.dtype == torch.bfloat16:
            return v.float().numpy()
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _same(a, b):
    return set(a) == set(b) and all(
        np.array_equal(a[n], b[n], equal_nan=True) for n in a)


# ---------------------------------------------------------------------------
# vars, params, persistables, inference model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("filename", [None, "params.npz"],
                         ids=["per_var", "combined"])
@pytest.mark.parametrize("which", ["vars", "params", "persistables"])
def test_round_trip_is_bit_exact(tmp_path, which, filename):
    s = Session()
    s.run(_feed())
    save = getattr(tfluid.io, f"save_{which}")
    load = getattr(tfluid.io, f"load_{which}")
    save(s.exe, str(tmp_path), s.main, filename=filename, scope=s.scope)
    s2 = Session()
    before = s2.image()
    load(s2.exe, str(tmp_path), s2.main, filename=filename, scope=s2.scope)
    got, want = s2.image(), s.image()
    params = {p.name for p in s.main.all_parameters()}
    for n in want:
        if which == "params" and n not in params:
            assert np.array_equal(got[n], before[n]), n
        else:
            assert np.array_equal(got[n], want[n]), n
    for n in s2.scope.vars:
        assert s2.scope.find_var(n).device == s2.exe.device


def test_files_are_byte_identical_to_the_jax_package(tmp_path):
    """Same values in both scopes: the manifest and each ``.npy`` the port
    writes are the JAX package's bytes."""
    j, t = Session("jax"), Session("torch")
    state = {n: np.asarray(j.scope.find_var(n)) for n in j.scope.vars}
    scope_from_numpy(state, t.scope, tfluid.CPUPlace(), programs=[t.main])
    jfluid.io.save_persistables(j.exe, str(tmp_path / "j"), j.main,
                                scope=j.scope)
    tfluid.io.save_persistables(t.exe, str(tmp_path / "t"), t.main,
                                scope=t.scope)
    names = sorted(os.listdir(tmp_path / "j"))
    assert names == sorted(os.listdir(tmp_path / "t"))
    assert "manifest.json" in names
    for n in names:
        assert (tmp_path / "t" / n).read_bytes() == \
            (tmp_path / "j" / n).read_bytes(), n


def test_bfloat16_blob_is_the_jax_package_format(tmp_path):
    """A bfloat16 var: the port writes the JAX package's bytes (descr
    ``<V2``, "bfloat16" in the manifest) and reads the JAX package's file
    back as a bfloat16 tensor, bit for bit."""
    import jax.numpy as jnp

    vals = np.random.RandomState(0).randn(3, 5).astype(np.float32)
    for pkg in PKGS:
        fl, un = PKGS[pkg]
        with un.guard():
            main = fl.Program()
            main.global_block.create_var(name="h", shape=(3, 5),
                                         dtype="bfloat16", persistable=True)
        scope = fl.Scope()
        if pkg == "jax":
            scope.set_var("h", jnp.asarray(vals, jnp.bfloat16))
        else:
            scope.set_var("h", torch.from_numpy(vals).bfloat16())
        fl.io.save_persistables(fl.Executor(fl.CPUPlace()),
                                str(tmp_path / pkg), main, scope=scope)
    for n in ("h.npy", "manifest.json"):
        assert (tmp_path / "torch" / n).read_bytes() == \
            (tmp_path / "jax" / n).read_bytes(), n
    assert b"'descr': '<V2'" in (tmp_path / "torch" / "h.npy").read_bytes()
    manifest = json.loads((tmp_path / "torch" / "manifest.json").read_text())
    assert manifest["vars"]["h"]["dtype"] == "bfloat16"
    with tun.guard():
        main = tfluid.Program()
        main.global_block.create_var(name="h", shape=(3, 5),
                                     dtype="bfloat16", persistable=True)
    scope = tfluid.Scope()
    tfluid.io.load_persistables(tfluid.Executor(tfluid.CPUPlace()),
                                str(tmp_path / "jax"), main, scope=scope)
    got = scope.find_var("h")
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, torch.from_numpy(vals).bfloat16())


def test_inference_model_round_trip_prunes_the_optimizer(tmp_path):
    s = Session()
    s.run(_feed())
    pred = s.main.global_block.ops[1].outputs["Out"][0]
    tfluid.io.save_inference_model(str(tmp_path / "m"), ["x"], [pred],
                                   s.exe, main_program=s.main,
                                   scope=s.scope)
    xb = _feed()["x"]
    want = s.exe.run(s.main.clone(for_test=True), feed=_feed(),
                     fetch_list=[pred], scope=s.scope)[0]
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    prog, feeds, fetches = tfluid.io.load_inference_model(
        str(tmp_path / "m"), exe, scope=scope)
    assert feeds == ["x"]
    assert not any(op.type in ("adam", "sgd")
                   for op in prog.global_block.ops)
    got = exe.run(prog, feed={"x": xb}, fetch_list=fetches, scope=scope)[0]
    assert np.array_equal(got, want)


@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_inference_model_crosses_packages(tmp_path, direction):
    src, dst = direction.split("_to_")
    s = Session(src)
    s.run(_feed())
    pred = s.main.global_block.ops[1].outputs["Out"][0]
    PKGS[src][0].io.save_inference_model(
        str(tmp_path / "m"), ["x"], [pred], s.exe, main_program=s.main,
        scope=s.scope)
    xb = _feed(seed=3)["x"]
    want = s.exe.run(s.main.clone(for_test=True), feed=_feed(seed=3),
                     fetch_list=[pred], scope=s.scope)[0]
    fl = PKGS[dst][0]
    exe, scope = fl.Executor(fl.CPUPlace()), fl.Scope()
    prog, feeds, fetches = fl.io.load_inference_model(str(tmp_path / "m"),
                                                      exe, scope=scope)
    got = exe.run(prog, feed={"x": xb}, fetch_list=[f.name for f in fetches],
                  scope=scope)[0]
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# checkpoint integrity (tests/test_resilience.py)
# ---------------------------------------------------------------------------

def test_checkpoint_manifest_and_verify_roundtrip(tmp_path):
    s = Session()
    ck = str(tmp_path / "checkpoint_0")
    s.run(_feed())
    s.save(ck, meta={"step": 1})
    manifest = resilience.verify_checkpoint(ck)
    assert manifest["format_version"] == 1
    assert resilience.FORMAT_VERSION >= manifest["format_version"]
    assert set(manifest["files"]) == {"ckpt.npz", "meta.json"}
    assert all("sha256" in f and "bytes" in f
               for f in manifest["files"].values())
    assert manifest["framework_version"] == tfluid.__version__ == \
        jfluid.__version__
    assert s.load(ck)["step"] == 1


def test_tampered_blob_is_detected_not_loaded(tmp_path):
    s = Session()
    ck = str(tmp_path / "checkpoint_0")
    s.save(ck, meta={"step": 3})
    blob = os.path.join(ck, "ckpt.npz")
    raw = bytearray(open(blob, "rb").read())
    raw[len(raw) // 2] ^= 0xFF
    with open(blob, "wb") as f:
        f.write(raw)
    before = s.image()
    with pytest.raises(CheckpointCorruptError) as ei:
        s.load(ck)
    assert ei.value.code == "PT603"
    assert _same(before, s.image())


def test_corruption_codes_name_what_failed(tmp_path):
    s = Session()
    ck = str(tmp_path / "checkpoint_0")
    s.save(ck)
    os.remove(os.path.join(ck, "meta.json"))
    with pytest.raises(CheckpointCorruptError) as ei:
        resilience.verify_checkpoint(ck)
    assert ei.value.code == "PT602" and "meta.json" in str(ei.value)
    with open(os.path.join(ck, "manifest.json"), "w") as f:
        f.write("{ not json")
    with pytest.raises(CheckpointCorruptError) as ei:
        resilience.verify_checkpoint(ck)
    assert ei.value.code == "PT601"
    os.remove(os.path.join(ck, "manifest.json"))
    with pytest.raises(CheckpointCorruptError) as ei:
        resilience.verify_checkpoint(ck)
    assert ei.value.code == "PT600"
    s.save(ck)
    mpath = os.path.join(ck, "manifest.json")
    m = json.load(open(mpath))
    m["format_version"] = resilience.FORMAT_VERSION + 1
    with open(mpath, "w") as f:
        json.dump(m, f)
    with pytest.raises(CheckpointCorruptError) as ei:
        resilience.verify_checkpoint(ck)
    assert ei.value.code == "PT604"
    # the messages are the JAX package's, letter for letter
    with pytest.raises(jres.CheckpointCorruptError) as ej:
        jres.verify_checkpoint(ck)
    assert str(ej.value) == str(ei.value)


def test_sharded_checkpoints_are_refused_with_the_missing_module(tmp_path):
    """The sharded format is ported (tests/test_torch_resilience_dist.py):
    a ``mesh`` save writes format_version 2 and restores every value; a
    plain manifest stamped 2 (no sharding section) loads as plain."""
    s = Session()
    ck = str(tmp_path / "checkpoint_0")
    tfluid.io.save_checkpoint(s.exe, ck, s.main, scope=s.scope,
                              mesh={"dp": 2})
    assert resilience.verify_checkpoint(ck)["format_version"] == 2
    before = {n: s.scope.numpy(n) for n in s.scope.vars}
    scope2 = tfluid.Scope()
    tfluid.io.load_checkpoint(s.exe, ck, s.main, scope=scope2)
    for n, v in before.items():
        np.testing.assert_array_equal(scope2.numpy(n), v, err_msg=n)
    ck1 = str(tmp_path / "checkpoint_1")
    s.save(ck1)
    mpath = os.path.join(ck1, "manifest.json")
    m = json.load(open(mpath))
    m["format_version"] = 2
    with open(mpath, "w") as f:
        json.dump(m, f)
    s.load(ck1)


def test_failed_save_preserves_previous_checkpoint(tmp_path):
    s = Session()
    ck = str(tmp_path / "checkpoint_0")
    s.save(ck, meta={"step": 1})
    with fault_plan_guard("ckpt_write:1:RuntimeError"):
        with pytest.raises(RuntimeError):
            s.save(ck, meta={"step": 2})
    resilience.verify_checkpoint(ck)
    assert s.load(ck)["step"] == 1
    assert [p for p in os.listdir(str(tmp_path)) if ".tmp." in p] == []


def test_save_checkpoint_over_nonempty_dir_replaces_atomically(tmp_path):
    s = Session()
    ck = str(tmp_path / "checkpoint_0")
    s.save(ck, meta={"step": 1})
    s.run(_feed())
    s.save(ck, meta={"step": 2})
    resilience.verify_checkpoint(ck)
    assert s.load(ck)["step"] == 2
    assert [p for p in os.listdir(str(tmp_path)) if "replaced" in p] == []


def test_dirname_exists_as_file_raises_clear_error(tmp_path):
    s = Session()
    as_file = tmp_path / "not_a_dir"
    as_file.write_text("occupied")
    with pytest.raises(ValueError, match="exists as a FILE"):
        s.save(str(as_file))
    with pytest.raises(ValueError, match="exists as a FILE"):
        tfluid.io.save_persistables(s.exe, str(as_file), s.main,
                                    scope=s.scope)
    with pytest.raises(ValueError, match="exists as a FILE"):
        tfluid.io.save_inference_model(str(as_file), ["x"], [s.loss],
                                       s.exe, main_program=s.main,
                                       scope=s.scope)


def test_shape_mismatch_load_leaves_scope_untouched(tmp_path):
    s = Session()
    ck = str(tmp_path / "checkpoint_0")
    s.run(_feed())
    s.save(ck)
    s2 = Session(width=2)          # same var names, fc width 2
    before = s2.image()
    with pytest.raises(RuntimeError, match="shape mismatch"):
        s2.load(ck)
    assert _same(before, s2.image())


def _fallbacks(code):
    return tmonitor.metric_value("trainer_ckpt_fallback_total",
                                 default=0.0, code=code)


def test_recovery_walk_falls_back_past_torn_checkpoint(tmp_path):
    s = Session()
    s.run(_feed())
    s.save(str(tmp_path / "checkpoint_0"), meta={"step": 7})
    good = s.image()
    torn = tmp_path / "checkpoint_1"
    torn.mkdir()
    (torn / "ckpt.npz").write_bytes(b"\x00\x01garbage")
    (torn / "meta.json").write_text('{"step": 999}')
    # garbage that recovery must ignore
    (tmp_path / "README").write_text("junk")
    (tmp_path / "checkpoint_notanumber").mkdir()
    (tmp_path / ".checkpoint_7.tmp.123").mkdir()
    assert [n for n, _ in resilience.iter_serials(str(tmp_path))] == [0, 1]
    before = _fallbacks("PT600")
    s2 = Session()
    meta, serial, skipped = resilience.load_latest_checkpoint(
        s2.exe, str(tmp_path), main_program=s2.main, scope=s2.scope)
    assert (meta["step"], serial) == (7, 0)
    assert [(k["serial"], k["code"]) for k in skipped] == [(1, "PT600")]
    assert _fallbacks("PT600") == before + 1
    assert _same(good, s2.image())


def test_recovery_falls_back_to_legacy_checkpoint_when_nothing_verifies(
        tmp_path):
    s = Session()
    s.save(str(tmp_path / "checkpoint_0"), meta={"step": 11})
    mpath = tmp_path / "checkpoint_0" / "manifest.json"
    m = json.load(open(mpath))
    del m["files"]
    with open(mpath, "w") as f:
        json.dump(m, f)
    meta, serial, _ = resilience.load_latest_checkpoint(
        s.exe, str(tmp_path), main_program=s.main, scope=s.scope)
    assert (meta["step"], serial) == (11, 0)
    # once a verified serial exists, a newer legacy-shaped dir is skipped
    s.save(str(tmp_path / "checkpoint_1"), meta={"step": 11})
    torn = tmp_path / "checkpoint_5"
    torn.mkdir()
    (torn / "ckpt.npz").write_bytes(b"junk")
    _, serial, _ = resilience.load_latest_checkpoint(
        s.exe, str(tmp_path), main_program=s.main, scope=s.scope)
    assert serial == 1


# ---------------------------------------------------------------------------
# resume (tests/test_resume.py)
# ---------------------------------------------------------------------------

def test_resume_walks_past_torn_checkpoint_and_trains_on(tmp_path):
    """The newest serial is torn; recovery lands on the last verified one
    (params and the data cursor in meta), and the resumed run's losses
    equal the uninterrupted run's bit for bit."""
    feeds = [_feed(seed=i) for i in range(8)]
    full = Session()
    want = [float(full.run(f)[0]) for f in feeds]
    s = Session()
    for f in feeds[:4]:
        s.run(f)
    s.save(str(tmp_path / "checkpoint_4"), meta={"step": 4,
                                                 "reader": {"batch": 4}})
    torn = tmp_path / "checkpoint_9"
    torn.mkdir()
    (torn / "ckpt.npz").write_bytes(b"not really an npz")
    (torn / "meta.json").write_text('{"step": 9}')
    s2 = Session()
    meta, serial, skipped = resilience.load_latest_checkpoint(
        s2.exe, str(tmp_path), main_program=s2.main, scope=s2.scope)
    assert serial == 4 and meta["step"] == 4
    assert [k["serial"] for k in skipped] == [9]
    assert str(skipped[0]["code"]).startswith("PT6")
    assert _same(s.image(), s2.image())
    got = [float(s2.run(f)[0]) for f in feeds[meta["reader"]["batch"]:]]
    assert got == want[4:]
    assert not os.path.exists(str(tmp_path / "checkpoint_9" /
                                  "manifest.json"))


def test_tampered_checkpoint_refused_on_resume(tmp_path):
    s = Session()
    tfluid.io.save_checkpoint(s.exe, str(tmp_path), s.main, scope=s.scope,
                              meta={"step": 2})
    blob = tmp_path / "ckpt.npz"
    raw = bytearray(blob.read_bytes())
    raw[len(raw) // 3] ^= 0x5A
    blob.write_bytes(bytes(raw))
    s2 = Session()
    before = s2.image()
    with pytest.raises(CheckpointCorruptError) as ei:
        s2.load(str(tmp_path))
    assert ei.value.code == "PT603"
    assert _same(before, s2.image())


# ---------------------------------------------------------------------------
# across packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("amp", [False, True], ids=["f32", "bf16_amp"])
@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_checkpoint_crosses_packages(tmp_path, direction, amp):
    """Saved after two steps by one package, loaded by the other into a
    fresh scope (verified manifest): every persistable equal to what was
    saved, and the next steps in the loading package give the losses the
    saving package gives: three at f32 rtol 1e-5 / atol 1e-6, and under
    AMP the first at the bf16 rtol 1e-3 (the packages round the bf16
    products differently and Adam's scale-free step carries that into
    the next steps' losses: 1.6e-3 at the third, with the loaded state
    bit-exact)."""
    src, dst = direction.split("_to_")
    a = Session(src, amp=amp)
    b_init = Session("jax", amp=amp)   # the weights both runs start from
    state = {n: np.asarray(b_init.scope.find_var(n))
             for n in b_init.scope.vars}
    if src == "torch":
        scope_from_numpy(state, a.scope, tfluid.CPUPlace(),
                         programs=[a.main])
    else:
        a.scope = b_init.scope
    for i in range(2):
        a.run(_feed(seed=i))
    a.save(str(tmp_path / "checkpoint_2"), meta={"step": 2})
    saved = a.image()
    b = Session(dst, amp=amp)
    fl = PKGS[dst][0]
    meta = fl.io.load_checkpoint(b.exe, str(tmp_path / "checkpoint_2"),
                                 b.main, scope=b.scope)
    assert meta == {"step": 2}
    got = b.image()
    for n, v in saved.items():
        assert np.array_equal(got[n].astype(v.dtype), v), n
    rtol = 1e-3 if amp else RTOL
    for i in range(2, 3 if amp else 5):
        la = a.run(_feed(seed=i))[0]
        lb = b.run(_feed(seed=i))[0]
        np.testing.assert_allclose(lb, la, rtol=rtol, atol=ATOL,
                                   err_msg=f"step {i}")
