"""High-level Trainer / Inferencer of the PyTorch port (counterpart of
``paddle_tpu/contrib/trainer.py``; reference
python/paddle/contrib/trainer.py:169 Trainer with epoch/step events,
:100 CheckpointConfig, :663 incremental save_checkpoint;
python/paddle/contrib/inferencer.py:31 Inferencer).

The event loop, checkpointing cadence and callbacks mirror the reference
and the JAX package; execution rides the port's executor on one card, or
with ``parallel=True`` a data-parallel ``CompiledProgram`` over the
launched ranks (each rank's reader yields its slice of the global batch).
``place=None`` means ``CUDAPlace(0)`` (it raises without a card; pass
``CPUPlace()`` for the CPU), where the JAX package picks the CPU.

The resilience stack, as far as one card goes:

* **recovery walk**: ``_load_latest`` resumes from the newest checkpoint
  that verifies (``resilience.load_latest_checkpoint``), skipping torn
  serials;
* **deterministic resume**: every checkpoint carries a ``data_cursor``
  (``resilience.elastic.DataCursor``: epoch, batch offset, the reader's
  own state such as a seeded ``reader.shuffle``'s), and ``train()``
  fast-forwards the reader past the committed batches, so a resumed run
  consumes exactly the not-yet-committed batch sequence;
* **device loss**: a step error that classifies as a lost device
  (``elastic.classify_device_error``; the ``device_lost`` fault site
  injects one) propagates as a typed ``DeviceLostError`` with the last
  verified checkpoint intact. Re-forming the group on the survivors is
  ROADMAP Queue A item 6 (slice 25);
* **sharded checkpoints** (``CheckpointConfig(sharded=True)``): the
  format-2 checkpoint, each rank writing its rows of the ZeRO-1 state;
* **divergence restore** (``FLAGS_replica_divergence_policy=restore``):
  during ``train()`` the Trainer registers its recovery walk with
  ``resilience.distributed.set_divergence_recovery``; a detected
  divergence reloads the newest verified checkpoint; the step counter
  takes the checkpoint's step, the rolled-back step gets no
  ``EndStepEvent``, and the data stream rewinds to the checkpoint's
  cursor, so each batch affects the restored lineage once;
* **graceful shutdown** (``resilience.graceful``): ``train()`` installs
  SIGTERM handlers for its duration; on a preemption notice the
  in-flight step finishes, a final verified checkpoint (data cursor
  included) is written, and ``train()`` returns with ``.interrupted``
  set so the process can exit 0.

Each step is one trace (``trainer.step``, with ``trainer.data`` and
``trainer.checkpoint`` under it) and marks its reader pull
(``trainer::read``) and ``DataFeeder.feed`` (``trainer::feed``) with
``profiler.RecordEvent``.
"""
from __future__ import annotations

import logging
import os
import shutil
import time
from typing import Callable, Optional

import numpy as np

from .. import io as io_mod
from .. import monitor as _monitor
from .. import resilience as _resilience
from .. import trace as _trace
from ..executor import CUDAPlace, Executor, Scope, scope_guard
from ..framework import Program, program_guard
from ..parallel.compiled_program import CompiledProgram
from ..profiler import RecordEvent
from ..resilience import elastic as _elastic
from ..resilience import faults as _faults
from ..resilience import distributed as _rdist
from ..resilience import graceful as _graceful
from .. import distributed as _pdist

__all__ = ["Trainer", "Inferencer", "CheckpointConfig",
           "BeginEpochEvent", "EndEpochEvent", "BeginStepEvent",
           "EndStepEvent"]

logger = logging.getLogger("paddle_tpu_torch.resilience")

_END = object()
# _run_step's outcome when a divergence restore rolled the step back
_REWIND = object()


class _EpochRewind(Exception):
    """Internal control flow: a mid-step restore (divergence policy)
    rolled the state back to a checkpoint that carries a data cursor;
    the epoch loop re-enters from that cursor."""


class BeginEpochEvent:
    def __init__(self, epoch_id):
        self.epoch = epoch_id


class EndEpochEvent:
    def __init__(self, epoch_id):
        self.epoch = epoch_id


class BeginStepEvent:
    def __init__(self, epoch_id, step_id):
        self.epoch, self.step = epoch_id, step_id
        self.fetch_metrics = True


class EndStepEvent:
    def __init__(self, epoch_id, step_id, metrics):
        self.epoch, self.step, self.metrics = epoch_id, step_id, metrics


class CheckpointConfig:
    """reference contrib/trainer.py:100; ``sharded=True`` selects the
    format_version-2 sharded checkpoint (resilience.distributed): one blob
    per rank's rows of the row-sharded state, restorable on another rank
    count."""

    def __init__(self, checkpoint_dir: str, max_num_checkpoints: int = 3,
                 epoch_interval: int = 1, step_interval: int = 10,
                 sharded: bool = False):
        self.checkpoint_dir = checkpoint_dir
        self.max_num_checkpoints = max_num_checkpoints
        self.epoch_interval = max(1, epoch_interval)
        self.step_interval = max(1, step_interval)
        self.sharded = bool(sharded)


class Trainer:
    """reference contrib/trainer.py:169: train_func returns the loss var
    (after building the whole model under this trainer's programs)."""

    def __init__(self, train_func: Callable, optimizer_func: Callable,
                 place=None, checkpoint_config: Optional[CheckpointConfig]
                 = None, parallel: bool = False, build_strategy=None):
        self._parallel = bool(parallel)
        self._build_strategy = build_strategy
        self._train_prog = None      # the CompiledProgram when parallel
        self.main_program = Program()
        self.startup_program = Program()
        self._ckpt = checkpoint_config
        with program_guard(self.main_program, self.startup_program):
            loss = train_func()
            if isinstance(loss, (list, tuple)):
                loss = loss[0]
            self.loss = loss
            optimizer_func().minimize(loss)
        self.place = place if place is not None else CUDAPlace(0)
        self.exe = Executor(self.place)
        self.scope = Scope()
        self._step = 0
        self.interrupted = False         # graceful shutdown unwound train()
        # data cursor: where the NEXT batch comes from (epoch, batch,
        # reader state); checkpointed in meta so resume fast-forwards
        self._cursor = _elastic.DataCursor()
        self._resume_cursor: Optional[_elastic.DataCursor] = None
        # the checkpoint's step after a divergence restore inside a step
        self._restored_step: Optional[int] = None
        with scope_guard(self.scope):
            self.exe.run(self.startup_program)
        if self._ckpt:
            self._load_latest()

    # -- checkpoints -----------------------------------------------------
    def _ckpt_path(self, serial: int) -> str:
        return os.path.join(self._ckpt.checkpoint_dir, f"checkpoint_{serial}")

    def _serials(self):
        """Serials of ``checkpoint_<int>`` DIRECTORIES only, ascending.
        Stray files, torn temp dirs and non-numeric entries in the
        checkpoint dir are ignored (resilience.iter_serials)."""
        return [s for s, _ in
                _resilience.iter_serials(self._ckpt.checkpoint_dir)]

    def _ckpt_mesh(self):
        """The mesh handed to sharded saves: the training mesh when
        parallel, else one rank (a valid single-shard v2 checkpoint)."""
        if not (self._ckpt and self._ckpt.sharded):
            return None
        if self._train_prog is not None:
            return self._train_prog._mesh
        return {"dp": 1}

    def _program_to_run(self):
        if not self._parallel:
            return self.main_program
        if self._train_prog is None:
            self._train_prog = CompiledProgram(
                self.main_program).with_data_parallel(
                loss_name=self.loss.name,
                build_strategy=self._build_strategy)
        return self._train_prog

    def _save_checkpoint(self):
        serials = self._serials()
        serial = (serials[-1] + 1) if serials else 0
        with scope_guard(self.scope), \
                _trace.span("trainer.checkpoint", serial=serial,
                            step=self._step):
            io_mod.save_checkpoint(self.exe, self._ckpt_path(serial),
                                   self.main_program, scope=self.scope,
                                   meta={"step": self._step,
                                         "data_cursor":
                                             self._cursor.to_dict()},
                                   mesh=self._ckpt_mesh())
        if _monitor.enabled():
            _monitor.counter("trainer_checkpoints_total",
                             "checkpoints written by contrib.Trainer").inc()
        # rotate (reference keeps max_num_checkpoints); never the serial
        # just written, even with max_num_checkpoints=1 or a racing writer
        # that renumbered the listing under us. <=0 keeps full history.
        # Under launched ranks rank 0 rotates (the others only wrote)
        keep = int(self._ckpt.max_num_checkpoints)
        if keep <= 0 or (self._ckpt_mesh() is not None
                         and _pdist.get_rank() != 0):
            return
        for old in self._serials()[:-keep]:
            if old != serial:
                shutil.rmtree(self._ckpt_path(old), ignore_errors=True)

    def _load_latest(self):
        """Resume from the newest checkpoint that passes verification,
        walking serials newest -> oldest past torn/corrupt ones (each skip
        counts on ``trainer_ckpt_fallback_total`` and logs its PT6xx
        diagnostic). An empty or garbage-only checkpoint dir starts fresh
        at step 0 instead of crashing."""
        with scope_guard(self.scope):
            meta, serial, _skipped = _resilience.load_latest_checkpoint(
                self.exe, self._ckpt.checkpoint_dir,
                main_program=self.main_program, scope=self.scope)
        if meta is None:
            self._step = 0
            return None
        self._step = int(meta.get("step", 0))
        self._resume_cursor = _elastic.DataCursor.from_dict(
            meta.get("data_cursor"))
        return serial

    def _recover_from_checkpoint(self) -> bool:
        """Divergence-restore hook (FLAGS_replica_divergence_policy=
        restore): reload the newest VERIFIED checkpoint without zeroing
        the step counter on failure: a divergence with nothing restorable
        must escalate, not silently restart training at step 0."""
        with scope_guard(self.scope):
            meta, serial, _skipped = _resilience.load_latest_checkpoint(
                self.exe, self._ckpt.checkpoint_dir,
                main_program=self.main_program, scope=self.scope,
                allow_legacy=False)
        if meta is None:
            return False
        self._restored_step = int(meta.get("step", 0))
        # a checkpoint with a data cursor rewinds the data with the state
        # (the step loop unwinds through _EpochRewind)
        self._resume_cursor = _elastic.DataCursor.from_dict(
            meta.get("data_cursor"))
        return True

    # -- the loop --------------------------------------------------------
    def train(self, num_epochs: int, event_handler: Callable,
              reader: Callable, feed_order):
        from ..data_feeder import DataFeeder

        feeder = DataFeeder(feed_list=list(feed_order),
                            program=self.main_program)
        # SIGTERM/preemption notice -> finish the step, checkpoint, exit 0
        # (resilience.graceful). Scoped to this call: handlers restore on
        # exit; non-main-thread callers fall back to event polling only.
        prev_recovery = _rdist._recovery
        if self._ckpt:
            _rdist.set_divergence_recovery(self._recover_from_checkpoint)
        installed = _graceful.install_signal_handlers()
        self.interrupted = False
        try:
            epoch, skip = 0, 0
            if self._resume_cursor is not None:
                epoch, skip = self._consume_resume_cursor(reader)
            with scope_guard(self.scope):
                while epoch < num_epochs:
                    try:
                        if self._run_epoch(epoch, event_handler, feeder,
                                           reader, skip):
                            return     # graceful shutdown: checkpointed
                    except _EpochRewind:
                        # a divergence restore rolled the state back:
                        # the data stream rewinds with it
                        epoch, skip = self._consume_resume_cursor(reader)
                        continue
                    skip = 0
                    epoch += 1
        finally:
            # scoped to this loop: a stale trainer's recovery walk must
            # never swallow a later, unrelated run's divergence
            _rdist.set_divergence_recovery(prev_recovery)
            if installed:
                _graceful.uninstall_signal_handlers()

    def _consume_resume_cursor(self, reader):
        """(epoch, skip) to re-enter the loop at the pending cursor: the
        resume and the divergence rewind share it."""
        cur = self._resume_cursor or _elastic.DataCursor()
        self._resume_cursor = None
        cur.apply_to_reader(reader)
        return cur.epoch, cur.batch

    def _run_epoch(self, epoch, event_handler, feeder, reader,
                   skip) -> bool:
        """One epoch; ``skip`` batches are fast-forwarded (deterministic
        resume: those batches are already committed in the restored
        state). Returns True when a graceful shutdown unwound the loop."""
        event_handler(BeginEpochEvent(epoch))
        it = iter(reader())
        step = -1
        while True:
            with RecordEvent("trainer::read"):
                batch = next(it, _END)
            if batch is _END:
                break
            step += 1
            if step < skip:
                # resume fast-forward: the restored state already
                # contains these batches' effect — consume-and-drop so
                # the NEXT batch is exactly the first uncommitted one
                if _monitor.enabled():
                    _monitor.counter(
                        "elastic_data_fastforward_batches_total",
                        "batches skipped by the data-cursor "
                        "fast-forward on resume").inc()
                continue
            outcome = self._run_step(epoch, step, batch, event_handler,
                                     feeder, reader)
            if outcome is _REWIND:
                raise _EpochRewind()
            if outcome:
                return True
        event_handler(EndEpochEvent(epoch))
        # next batch after a completed epoch is the next epoch's first
        self._cursor = _elastic.DataCursor.capture(epoch + 1, 0, reader)
        if self._ckpt and (epoch + 1) % self._ckpt.epoch_interval == 0:
            self._save_checkpoint()
        return False

    def _run_step(self, epoch, step, batch, event_handler, feeder,
                  reader):
        """One step: True when a graceful shutdown unwound the loop,
        ``_REWIND`` when a divergence restore rolled it back, else
        False."""
        begin = BeginStepEvent(epoch, step)
        event_handler(begin)
        fetches = [self.loss.name] if begin.fetch_metrics else []
        # one trace per training step (root span; the feed build, the
        # executor dispatch and the checkpoint write land as children)
        with _trace.root_span("trainer.step", epoch=epoch, step=step,
                              global_step=self._step) as step_span:
            t0 = time.perf_counter()
            with _trace.span("trainer.data"), RecordEvent("trainer::feed"):
                fd = feeder.feed(batch)
            # a lost device surfaces at the dispatch or at the metric's
            # host read: either way it leaves typed (DeviceLostError)
            with _elastic.device_loss_classification("step"):
                _faults.fault_point("device_lost")
                vals = self.exe.run(self._program_to_run(), feed=fd,
                                    fetch_list=fetches, scope=self.scope)
                metrics = [float(np.asarray(v).reshape(-1)[0])
                           for v in vals]
            if self._restored_step is not None:
                # a divergence restore rolled this step back: the scope
                # holds the checkpoint's state, so the counter takes its
                # step, and no EndStepEvent is sent
                self._step, self._restored_step = self._restored_step, None
                if self._resume_cursor is not None:
                    step_span.set_attribute("outcome", "divergence_rewind")
                    return _REWIND
                # a checkpoint without a cursor: go on forward
            else:
                self._step += 1
            # the committed data position: the NEXT batch is step+1 of
            # this epoch (checkpointed with the state as data_cursor)
            self._cursor = _elastic.DataCursor.capture(epoch, step + 1,
                                                       reader)
            if _monitor.enabled():
                _monitor.counter("trainer_steps_total",
                                 "steps run by contrib.Trainer.train").inc()
                _monitor.histogram(
                    "trainer_step_seconds",
                    "Trainer step wall time (feed build + executor "
                    "dispatch + metric fetch)").observe(
                    time.perf_counter() - t0)
                if metrics:
                    _monitor.gauge("trainer_last_loss",
                                   "most recent fetched loss").set(
                        metrics[0])
            event_handler(EndStepEvent(epoch, step, metrics))
            saved = False
            if self._ckpt and self._step % self._ckpt.step_interval == 0:
                self._save_checkpoint()
                saved = True
            if not _graceful.shutdown_requested():
                step_span.set_attribute("outcome", "ok")
                return False
            # preemption notice: the in-flight step completed above;
            # write the final verified checkpoint (data cursor included)
            # and unwind so the process can exit 0 — never a duplicate
            # of the interval save that just ran
            if self._ckpt and not saved:
                self._save_checkpoint()
            self.interrupted = True
            if _monitor.enabled():
                _monitor.counter(
                    "trainer_graceful_exits_total",
                    "train() calls unwound by a graceful-shutdown request "
                    "after a final checkpoint").inc()
            logger.warning("graceful shutdown: step %d checkpointed, "
                           "train() returning cleanly", self._step)
            step_span.set_attribute("outcome", "graceful_exit")
            return True

    def save_params(self, dirname: str):
        with scope_guard(self.scope):
            io_mod.save_params(self.exe, dirname, self.main_program,
                               scope=self.scope)

    def save_inference_model(self, dirname, feeded_var_names, target_vars):
        with scope_guard(self.scope):
            io_mod.save_inference_model(dirname, feeded_var_names,
                                        target_vars, self.exe,
                                        main_program=self.main_program,
                                        scope=self.scope)

    def stop(self):
        self.exe.close()


class Inferencer:
    """reference contrib/inferencer.py:31: infer_func rebuilds the forward
    under fresh programs; params load from ``param_path``. ``place=None``
    means ``CUDAPlace(0)``. ``parallel=True`` runs the forward as a
    data-parallel ``CompiledProgram`` over the launched ranks: each rank
    feeds its slice and gets the whole batch's outputs back, gathered in
    rank order."""

    def __init__(self, infer_func: Callable, param_path: str, place=None,
                 parallel: bool = False):
        self.main_program = Program()
        self.startup_program = Program()
        with program_guard(self.main_program, self.startup_program):
            self.predict_var = infer_func()
        self.exe = Executor(place if place is not None else CUDAPlace(0))
        self.scope = Scope()
        with scope_guard(self.scope):
            self.exe.run(self.startup_program)
            io_mod.load_params(self.exe, param_path, self.main_program,
                               scope=self.scope)
        self._prog = (CompiledProgram(self.main_program).with_data_parallel()
                      if parallel else self.main_program)

    def infer(self, inputs: dict):
        with scope_guard(self.scope):
            (out,) = self.exe.run(self._prog, feed=inputs,
                                  fetch_list=[self.predict_var.name],
                                  scope=self.scope)
        return out
