"""The PyTorch port's persistent autotuner (``paddle_tpu_torch.tuning``),
on the CPU: the counterparts of the JAX package's ``tests/test_autotune.py``
— the cost-database round trip, staleness, a corrupt file, buckets,
content fingerprints, mode gating, use mode running the best triple
through ``LowerCtx``, explicit flags beating the DB, an uncontaminated
trial, concurrent recorders — plus what the port adds: the candidate set
is K5's compiled tilings, and the triple reaches the fusion witness and
the executor key.

The knob is the block triple (the reference's ``FLAGS_xla_options`` has
no counterpart in the port). On the CPU the fused op runs the kernel's
plain version under ``FLAGS_use_fused_gemm=always``, which receives the
triple as the kernel would: a spy on ``kernels.fused_gemm.fused_gemm``
records it. The cross-process round trip on the card is
``chip_smoke.py``'s ``tune`` phase and ``tools/torch_fusion_check.py``.
"""
import importlib
import os
import threading

import numpy as np
import pytest

from paddle_tpu import tuning as jtuning

import paddle_tpu_torch as fluid
import paddle_tpu_torch.unique_name as un
from paddle_tpu_torch import monitor, tuning

# the module (the kernels package re-exports its function under its name)
FG = importlib.import_module("paddle_tpu_torch.kernels.fused_gemm")

FLAGS = ["FLAGS_autotune", "FLAGS_autotune_db", "FLAGS_fused_gemm_blocks",
         "FLAGS_epilogue_fusion", "FLAGS_use_fused_gemm"]
CPU = "cpu"


@pytest.fixture(autouse=True)
def _tuning_isolation(tmp_path):
    prev = fluid.get_flags(FLAGS)
    fluid.set_flags({"FLAGS_autotune_db":
                     str(tmp_path / "autotune_db.json")})
    tuning.reset_database_cache()
    yield
    fluid.set_flags(prev)
    tuning.reset_database_cache()


def _program(width=64, seed=7):
    """A small training program (SGD): the executor looks it up, fusion
    refuses it (backward ops)."""
    with un.guard():
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            x = fluid.layers.data("x", shape=[width], dtype="float32")
            y = fluid.layers.data("y", shape=[1], dtype="float32")
            h = fluid.layers.fc(x, width, act="relu")
            pred = fluid.layers.fc(h, 1)
            loss = fluid.layers.mean(
                fluid.layers.square(fluid.layers.elementwise_sub(pred, y)))
            fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
    main.random_seed = seed
    return main, startup, loss


def _infer_program(width=64):
    """A forward-only program with two fusable chains (fc + relu, fc)."""
    with un.guard():
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            x = fluid.layers.data("x", shape=[width], dtype="float32")
            h = fluid.layers.fc(x, width, act="relu")
            pred = fluid.layers.fc(h, width)
    return main, startup, pred


def _feed(batch, width=64, label=True, seed=0):
    rng = np.random.RandomState(seed)
    feed = {"x": rng.randn(batch, width).astype(np.float32)}
    if label:
        feed["y"] = rng.randn(batch, 1).astype(np.float32)
    return feed


def _gemm_components():
    """The ``gemm_blocks`` component of each executor compile event."""
    return [e.components["gemm_blocks"]
            for e in monitor.recompile_events(recompiles_only=False)
            if "gemm_blocks" in e.components]


@pytest.fixture
def blocks_spy(monkeypatch):
    """Records the (block_m, block_n, block_k) every K5 call on real
    tensors receives (shape inference calls it on meta tensors, at
    whatever triple, and computes nothing)."""
    seen = []
    real = FG.fused_gemm

    def spy(x, *args, **kw):
        if x.device.type != "meta":
            seen.append((kw["block_m"], kw["block_n"], kw["block_k"]))
        return real(x, *args, **kw)

    monkeypatch.setattr(FG, "fused_gemm", spy)
    return seen


# ---------------------------------------------------------------------------
# database
# ---------------------------------------------------------------------------

def test_db_round_trip_and_best():
    db = tuning.get_database()
    c1 = tuning.TunedConfig.make({}, (128, 128, 32))
    c2 = tuning.TunedConfig.make({}, (64, 64, 32))
    db.record("fp1", 64, CPU, c1, 0.02)
    db.record("fp1", 64, CPU, c2, 0.01)
    best = db.best("fp1", 64, CPU)
    assert best["candidate"]["gemm_blocks"] == [64, 64, 32]
    assert best["candidate"]["xla_options"] == {}
    # re-measuring a candidate replaces its trial, never duplicates
    db.record("fp1", 64, CPU, c2, 0.03)
    assert db.trial_count() == 2
    assert db.best("fp1", 64, CPU)["candidate"]["gemm_blocks"] == \
        [128, 128, 32]
    # durable: a fresh CostDatabase object reloads from disk
    db2 = tuning.CostDatabase(db.path)
    assert db2.trial_count() == 2
    assert db2.best("fp1", 64, CPU) == db.best("fp1", 64, CPU)


def test_db_schema_matches_the_reference(tmp_path):
    """Both packages write the same schema and field names: a database
    file either one wrote loads in the other (the version fields differ,
    so neither ranks the other's trials)."""
    cand = tuning.TunedConfig.make({}, (64, 128, 32))
    trial = tuning.get_database().record("fp", 8, CPU, cand, 0.5)
    jp = str(tmp_path / "jax_db.json")
    jtrial = jtuning.CostDatabase(jp).record(
        "fp", 8, CPU, jtuning.TunedConfig.make({}, (64, 128, 32)), 0.5)
    assert set(trial) == set(jtrial)
    assert trial["candidate"] == jtrial["candidate"]
    assert tuning.CostDatabase(jp).trial_count() == 1
    assert tuning.CostDatabase(jp).best("fp", 8, CPU) is None
    assert tuning.CostDatabase.key("fp", 8, CPU) == \
        jtuning.CostDatabase.key("fp", 8, CPU)


def test_db_version_staleness_invalidates():
    """Trials recorded by a different framework or torch/CUDA version are
    invisible to best() — an upgrade invalidates its measurements."""
    db = tuning.get_database()
    db.record("fp2", 32, CPU, tuning.TunedConfig.make({}), 0.01)
    assert db.best("fp2", 32, CPU) is not None
    with db._lock:
        for e in db._load().values():
            for t in e["trials"]:
                t["jax_version"] = "torch 0.0.0-other cuda None"
    assert db.best("fp2", 32, CPU) is None


def test_db_corrupt_file_degrades_to_empty(tmp_path, caplog):
    p = str(tmp_path / "bad.json")
    with open(p, "w") as f:
        f.write("{not json")
    db = tuning.CostDatabase(p)
    with caplog.at_level("WARNING", logger="paddle_tpu_torch.tuning"):
        assert db.trial_count() == 0
    assert sum("unreadable" in r.getMessage() for r in caplog.records) == 1
    db.record("fp", 1, CPU, tuning.TunedConfig.make({}), 0.5)
    assert tuning.CostDatabase(p).trial_count() == 1


def test_shape_bucket_powers_of_two():
    assert [tuning.shape_bucket(b) for b in (1, 2, 3, 64, 65, 128)] == \
        [1, 2, 4, 64, 128, 128]
    assert [tuning.shape_bucket(b) for b in (1, 2, 3, 64, 65, 128)] == \
        [jtuning.shape_bucket(b) for b in (1, 2, 3, 64, 65, 128)]


def test_content_fingerprint_stable_across_builds():
    m1, _, _ = _program()
    m2, _, _ = _program()
    m3, _, _ = _program(width=32)
    assert tuning.program_content_fingerprint(m1) == \
        tuning.program_content_fingerprint(m2)
    assert tuning.program_content_fingerprint(m1) != \
        tuning.program_content_fingerprint(m3)
    assert m1._serial != m2._serial  # serials differ; content hash doesn't


def test_candidates_are_the_compiled_tilings():
    """The baseline runs the compiled default; one candidate per other
    compiled triple, each one the kernel takes."""
    base = tuning.default_candidates()
    assert [c.to_dict() for c in base] == [
        {"xla_options": {}, "gemm_blocks": None}]
    cands = tuning.default_candidates(include_gemm_blocks=True)
    assert len(cands) == 4 and cands[0].gemm_blocks is None
    assert {c.gemm_blocks for c in cands[1:]} | {FG.DEFAULT_BLOCKS} == \
        set(FG.COMPILED_BLOCKS)
    for c in cands[1:]:
        kind, reason = FG.classify_gemm(256, 256, 256,
                                        block_m=c.gemm_blocks[0],
                                        block_n=c.gemm_blocks[1],
                                        block_k=c.gemm_blocks[2])
        assert kind == "supported", reason


# ---------------------------------------------------------------------------
# mode gating
# ---------------------------------------------------------------------------

def test_record_requires_measure_mode():
    main, _, _ = _program()
    for mode in ("off", "use"):
        fluid.set_flags({"FLAGS_autotune": mode})
        with pytest.raises(RuntimeError, match="measure"):
            tuning.record_trial(main, 8, tuning.TunedConfig.make({}), 0.1)
    fluid.set_flags({"FLAGS_autotune": "measure"})
    tuning.record_trial(main, 8, tuning.TunedConfig.make({}), 0.1)
    assert tuning.get_database().trial_count() == 1
    with pytest.raises(ValueError, match="off"):
        fluid.set_flags({"FLAGS_autotune": "sometimes"})


def test_lookup_off_mode_never_touches_db():
    main, _, _ = _program()
    fluid.set_flags({"FLAGS_autotune": "off"})
    assert tuning.lookup_best(main, 8) is None
    assert not os.path.exists(tuning.default_db_path())
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    _, startup, loss = _program()
    exe.run(startup, scope=scope)
    exe.run(main, feed=_feed(8), fetch_list=[loss], scope=scope)
    assert not os.path.exists(tuning.default_db_path())
    assert not exe._tuning_cache


# ---------------------------------------------------------------------------
# executor integration
# ---------------------------------------------------------------------------

def _seed_best(main, batch, blocks):
    fluid.set_flags({"FLAGS_autotune": "measure"})
    tuning.record_trial(main, batch, tuning.TunedConfig.make({}, blocks),
                        0.001)
    # a worse candidate the executor must NOT pick
    tuning.record_trial(main, batch, tuning.TunedConfig.make({}), 0.5)


def test_executor_use_mode_runs_best_triple_through_lowerctx(blocks_spy):
    """Use mode: the best-known triple reaches every K5 call of the run
    through ``LowerCtx.gemm_blocks`` (the witness's and the step's), is
    in the compile event's components, and no trial runs."""
    main, startup, pred = _infer_program()
    batch, best = 16, (64, 128, 32)
    _seed_best(main, batch, best)
    fluid.set_flags({"FLAGS_autotune": "use", "FLAGS_epilogue_fusion": 1,
                     "FLAGS_use_fused_gemm": "always"})
    monitor.reset()
    exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    exe.run(startup, scope=scope)
    (out,) = exe.run(main, feed=_feed(batch, label=False),
                     fetch_list=[pred], scope=scope)
    assert np.isfinite(out).all()
    assert (monitor.metric_value("autotune_hits_total") or 0) >= 1
    assert (monitor.metric_value("autotune_trials_total") or 0) == 0
    assert blocks_spy and set(blocks_spy) == {best}
    assert _gemm_components()[-1] == best
    assert monitor.metric_value(
        "autotune_best_per_step_seconds",
        program=tuning.program_content_fingerprint(main),
        bucket="16") == pytest.approx(0.001)
    assert not hasattr(main, "_tuned_gemm_blocks")


def test_explicit_flags_beat_db(blocks_spy):
    main, startup, pred = _infer_program()
    batch = 16
    _seed_best(main, batch, (64, 64, 32))
    fluid.set_flags({"FLAGS_autotune": "use",
                     "FLAGS_fused_gemm_blocks": "128,128,32",
                     "FLAGS_epilogue_fusion": 1,
                     "FLAGS_use_fused_gemm": "always"})
    monitor.reset()
    exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    exe.run(startup, scope=scope)
    exe.run(main, feed=_feed(batch, label=False), fetch_list=[pred],
            scope=scope)
    assert set(blocks_spy) == {(128, 128, 32)}
    assert _gemm_components()[-1] == (128, 128, 32)
    # the explicit flag means the DB is never asked
    assert (monitor.metric_value("autotune_hits_total") or 0) == 0


def test_measure_candidates_records_and_ranks(blocks_spy):
    """Every default candidate is measured at its own triple (the
    baseline at the compiled default), recorded and ranked; a fresh
    use-mode executor then runs the best with no new trial."""
    main, startup, pred = _infer_program()
    fluid.set_flags({"FLAGS_autotune": "measure",
                     "FLAGS_epilogue_fusion": 1,
                     "FLAGS_use_fused_gemm": "always"})
    monitor.reset()
    exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    feed = _feed(8, label=False)
    exe.run(startup, scope=scope)
    cands = tuning.default_candidates(include_gemm_blocks=True)
    seen_by_cand = []
    for cand in cands:
        n0 = len(blocks_spy)
        rep = tuning.measure_candidates(exe, main, feed, [pred.name], scope,
                                        candidates=[cand], k_short=1,
                                        k_long=2)
        assert [t["status"] for t in rep["trials"]] == ["ok"], rep
        seen_by_cand.append(set(blocks_spy[n0:]))
    assert seen_by_cand == [{c.gemm_blocks or FG.DEFAULT_BLOCKS}
                            for c in cands]
    db = tuning.get_database()
    assert db.trial_count() == 4
    assert (monitor.metric_value("autotune_trials_total") or 0) == 4
    rep = tuning.measure_candidates(exe, main, feed, [pred.name], scope,
                                    candidates=cands[:2], k_short=1,
                                    k_long=2)
    ok = [t for t in rep["trials"] if t["status"] == "ok"]
    assert [t["rank"] for t in sorted(ok, key=lambda t: t["per_step_s"])] \
        == [0, 1]
    assert rep["best"] is not None and rep["backend"] == CPU
    assert db.trial_count() == 4
    best = db.best(tuning.program_content_fingerprint(main), 8, CPU)
    want = tuple(best["candidate"]["gemm_blocks"] or FG.DEFAULT_BLOCKS)
    # and a subsequent use-mode executor reuses the best with no trials
    fluid.set_flags({"FLAGS_autotune": "use"})
    exe2 = fluid.Executor(fluid.CPUPlace())
    n0 = len(blocks_spy)
    exe2.run(main, feed=feed, fetch_list=[pred], scope=scope)
    assert set(blocks_spy[n0:]) == {want}
    assert tuning.get_database().trial_count() == 4
    assert (monitor.metric_value("autotune_hits_total") or 0) >= 1


def test_autotune_off_drops_tuned_blocks_and_no_program_stamp():
    """Turning FLAGS_autotune off drops the DB's influence entirely: the
    off-mode run carries gemm_blocks=None in its compile components (a
    distinct executor key — it does not reuse the tuned step). The tuned
    triple is threaded per run, never stamped on the shared Program."""
    main, startup, loss = _program()
    batch = 16
    fluid.set_flags({"FLAGS_autotune": "measure"})
    tuning.record_trial(main, batch,
                        tuning.TunedConfig.make({}, (64, 128, 32)), 0.001)
    fluid.set_flags({"FLAGS_autotune": "use"})
    monitor.reset()
    exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    exe.run(startup, scope=scope)
    exe.run(main, feed=_feed(batch), fetch_list=[loss], scope=scope)
    assert _gemm_components()[-1] == (64, 128, 32)
    n_keys = len(exe._cache)
    fluid.set_flags({"FLAGS_autotune": "off"})
    exe.run(main, feed=_feed(batch), fetch_list=[loss], scope=scope)
    assert _gemm_components()[-1] is None
    assert len(exe._cache) == n_keys + 1
    assert not hasattr(main, "_tuned_gemm_blocks")
    assert {k[-2] for k in exe._cache} == {None, (64, 128, 32)}


def test_use_mode_hits_db_with_epilogue_fusion_enabled(blocks_spy):
    """Record/lookup key consistency under fusion: trials are recorded
    under the SUBMITTED program's content fingerprint, and the executor
    looks up with that same fingerprint though it runs the fused clone
    (whose content — fused_gemm_epilogue ops — differs); the fusion
    decision is keyed on the tuned triple and witnessed at it."""
    main, startup, pred = _infer_program()
    batch, best = 16, (128, 128, 32)
    fluid.set_flags({"FLAGS_autotune": "measure"})
    tuning.record_trial(main, batch, tuning.TunedConfig.make({}, best),
                        0.001)
    fluid.set_flags({"FLAGS_autotune": "use", "FLAGS_epilogue_fusion": 1,
                     "FLAGS_use_fused_gemm": "always"})
    monitor.reset()
    exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    exe.run(startup, scope=scope)
    exe.run(main, feed=_feed(batch, label=False), fetch_list=[pred],
            scope=scope)
    fused = [p for p in exe._fusion_cache.values()
             if any(op.type == "fused_gemm_epilogue"
                    for op in p.global_block.ops)]
    assert fused
    assert tuning.program_content_fingerprint(fused[0]) != \
        tuning.program_content_fingerprint(main)
    assert (monitor.metric_value("autotune_hits_total") or 0) >= 1
    assert [k[2] for k, p in exe._fusion_cache.items() if p in fused] == \
        [best]
    assert set(blocks_spy) == {best}


def test_measure_trial_not_contaminated_by_db_best(blocks_spy):
    """The in-trial guard: while measure_candidates runs a candidate, the
    executor runs exactly that candidate's config — never fills its unset
    triple from the DB's best-known entry, or the baseline {} trial would
    silently be measured under the tuned triple and recorded as if the
    default achieved its step time."""
    main, startup, pred = _infer_program()
    batch = 8
    fluid.set_flags({"FLAGS_autotune": "measure",
                     "FLAGS_epilogue_fusion": 1,
                     "FLAGS_use_fused_gemm": "always"})
    tuning.record_trial(main, batch,
                        tuning.TunedConfig.make({}, (64, 64, 32)),
                        0.000001)   # an irresistibly fast best
    monitor.reset()
    exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    exe.run(startup, scope=scope)
    n0 = len(blocks_spy)
    rep = tuning.measure_candidates(
        exe, main, _feed(batch, label=False), [pred.name], scope,
        candidates=[tuning.TunedConfig.make({})], k_short=1, k_long=2)
    assert [t["status"] for t in rep["trials"]] == ["ok"]
    assert set(blocks_spy[n0:]) == {FG.DEFAULT_BLOCKS}
    assert all(c is None for c in _gemm_components()), \
        "a trial run leaked the DB's best-known triple"
    assert not tuning.in_trial()


def test_concurrent_recorders_merge_on_save(tmp_path):
    """Two DB instances sharing one file (two measure-mode processes)
    union their trials on save, not last-writer-wins; and many threads
    recording through one instance lose nothing."""
    p = str(tmp_path / "shared_db.json")
    a, b = tuning.CostDatabase(p), tuning.CostDatabase(p)
    a._load()
    b._load()          # both memoize the (empty) file before either saves
    a.record("fp", 16, CPU, tuning.TunedConfig.make({}, (64, 64, 32)), 0.5)
    b.record("fp", 16, CPU, tuning.TunedConfig.make({}, (64, 128, 32)),
             0.4)
    fresh = tuning.CostDatabase(p)
    e = fresh._load()[tuning.CostDatabase.key("fp", 16, CPU)]
    cands = [t["candidate"]["gemm_blocks"] for t in e["trials"]]
    assert [64, 64, 32] in cands and [64, 128, 32] in cands

    shared = tuning.CostDatabase(str(tmp_path / "threads.json"))
    errors = []

    def worker(i):
        try:
            for j in range(5):
                shared.record(f"fp{i}", 8, CPU,
                              tuning.TunedConfig.make({}, (64, 64, 32)),
                              0.1 + j, save=(j == 4))
        except Exception as exc:   # surfaced by the assert below
            errors.append(exc)

    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not errors and not any(t.is_alive() for t in threads)
    assert tuning.CostDatabase(shared.path).trial_count() == 8


def test_lookup_never_raises_on_a_broken_database(monkeypatch, caplog):
    """The executor path's lookup degrades to "nothing known" with one
    warning, whatever the database does."""
    main, startup, loss = _program()
    fluid.set_flags({"FLAGS_autotune": "use"})

    def boom(*a, **k):
        raise OSError("disk gone")

    monkeypatch.setattr(tuning.CostDatabase, "best", boom)
    monkeypatch.setattr(tuning, "_warned_lookup", False)
    with caplog.at_level("WARNING", logger="paddle_tpu_torch.tuning"):
        assert tuning.lookup_best(main, 8) is None
        assert tuning.lookup_best(main, 8) is None
    assert sum("disabled" in r.getMessage() for r in caplog.records) == 1
    exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    exe.run(startup, scope=scope)
    (lv,) = exe.run(main, feed=_feed(8), fetch_list=[loss], scope=scope)
    assert np.isfinite(lv).all()


def test_backend_names_the_card():
    assert tuning.backend_name("cpu") == "cpu"
    assert tuning.backend_name(fluid.CPUPlace().torch_device()) == "cpu"
