"""Elastic preemption-tolerant training in the PyTorch port: device-loss
detection, mesh rescale planning and deterministic data resume
(counterpart of ``paddle_tpu/resilience/elastic.py``; all of it host
logic).

1. **Device-loss detection** — :func:`classify_device_error` maps an
   error raised at a step or collective site onto a typed
   :class:`DeviceLostError` (``transient = False``: retry never absorbs a
   dead device). It keeps the JAX package's patterns, so the cases the
   two packages share classify alike, and adds the CUDA runtime's texts
   for a device that is gone or unusable (``_CUDA_DEVICE_LOSS``, each
   named by its CUDA error). A program fault never counts: a device-side
   assert, an illegal address, a launch failure or running out of
   memory keep their own types. The ``device_lost`` fault site
   (``resilience.faults``) injects one deterministically.
2. **Mesh rescale** — :func:`plan_rescale` re-forms the axis layout on
   the surviving device set: the non-dp axes keep their sizes, the dp
   axis absorbs the loss; an unsatisfiable topology refuses with a PT61x
   :class:`ElasticRescaleError`.
3. **Global-batch preservation** — :func:`grad_accum_steps`: the
   per-replica gradient-accumulation factor that keeps the global batch
   after a rescale.
4. **Deterministic data resume** — :class:`DataCursor`: epoch, batch
   offset and the reader's own state (a seeded ``reader.shuffle``),
   checkpointed as ``meta.json: data_cursor``; ``contrib.Trainer``
   fast-forwards the reader past the committed batches on resume.

On one card there is no mesh to re-form: ``contrib.Trainer`` enables
recovery only for ``parallel`` runs, which wait for multi-device
(``CompiledProgram``), so a :class:`DeviceLostError` propagates, typed,
with the last verified checkpoint intact — as the JAX package behaves
with ``parallel=False``.
"""
from __future__ import annotations

import contextlib
import logging
import re
from typing import Dict, Optional, Sequence

__all__ = ["DeviceLostError", "ElasticRescaleError", "ELASTIC_CODES",
           "classify_device_error", "device_loss_classification",
           "record_device_lost", "plan_rescale", "grad_accum_steps",
           "format_axes", "DataCursor", "survivor_devices"]

logger = logging.getLogger("paddle_tpu_torch.resilience")

# PT61x: elastic-rescale diagnostics (sibling band of the checkpoint
# integrity PT60x codes in resilience/checkpoint.py; docs/RESILIENCE.md)
ELASTIC_CODES = {
    "PT610": "surviving devices cannot satisfy the mesh's non-dp axes "
             "(pp/sp need more devices than survive; dp is the only "
             "elastic axis)",
    "PT611": "surviving data-parallel width would fall below the "
             "configured minimum",
    "PT612": "elastic rescale budget exhausted (FLAGS_elastic_max_"
             "rescales) — repeated device loss is an outage, not churn",
    "PT613": "global batch is not divisible by any feasible surviving "
             "dp width — batch preservation is impossible on this "
             "topology",
    "PT614": "no verified checkpoint to restore after a device loss — "
             "elastic recovery has nothing to resume from",
}


class DeviceLostError(RuntimeError):
    """A device (or its host) is gone: preemption, reset, eviction.
    ``transient = False`` — :func:`resilience.retry.is_transient` must
    never classify a dead chip as infrastructure noise; backoff against
    a missing device only delays the mesh rescale. Carries the ``site``
    that observed the loss and (when the runtime could attribute it)
    the surviving device list."""

    transient = False

    def __init__(self, detail: str, site: str = "parallel_step",
                 survivors=None):
        self.site = site
        self.detail = detail
        self.survivors = survivors
        super().__init__(
            f"[elastic] device lost at site '{site}': {detail} — a dead "
            f"device is never retried. Resume from the last verified "
            f"checkpoint (contrib.Trainer does so on its next start); "
            f"rescaling a mesh onto the survivors needs multi-device "
            f"(ROADMAP Queue A item 6, slice 28).")


class ElasticRescaleError(RuntimeError):
    """The elastic path cannot recover — carries a stable PT61x ``code``
    (see :data:`ELASTIC_CODES`) naming exactly why. ``transient =
    False``: an unsatisfiable topology does not get better by retrying."""

    transient = False

    def __init__(self, code: str, detail: str):
        self.code = code
        self.detail = detail
        super().__init__(f"[{code}] elastic rescale refused: {detail} — "
                         f"{ELASTIC_CODES[code]}")


# -- 1. device-loss detection ----------------------------------------------

# the error zoo that means "a device/host is gone", as the JAX package
# curates it from PJRT/TPU-runtime failure strings (kept as it is, so the
# cases the two packages share classify alike), then the CUDA runtime's.
# Matched case-insensitively against the whole exception chain;
# deliberately specific — a generic RuntimeError must stay
# transient-retryable, and misclassifying a program fault as a dead
# device would hide the fault.
_JAX_DEVICE_LOSS = (
    r"site 'device_lost'",                    # the injected fault marker
    r"device\s+(?:\S+\s+)?(?:is\s+)?(?:lost|halted|rebooted|reset)",
    r"(?:tpu|device|chip|core)\s+.*\b(?:unhealthy|unavailable|"
    r"disappeared|removed)",
    r"\bpreempt(?:ed|ion)\b",
    r"slice\s+health|ici\s+.*\b(?:down|failure|timed?\s*out)",
    r"failed\s+to\s+(?:connect\s+to|enumerate)\s+.*(?:device|worker|host)",
    r"(?:socket\s+closed|connection\s+reset\s+by\s+peer)"
    r".*(?:worker|host|coordinator)",
    r"host\s+.*\b(?:evicted|terminated|unreachable)",
    r"\bNCCL\b.*\b(?:unhandled|failure|error)",
)
# the CUDA runtime's texts for a device that is gone or unusable, by CUDA
# error name. Left out on purpose, as program faults or ambiguous:
# cudaErrorAssert ("device-side assert triggered"),
# cudaErrorIllegalAddress, cudaErrorLaunchFailure ("unspecified launch
# failure"), cudaErrorLaunchTimeout, cudaErrorMemoryAllocation and
# torch's "CUDA out of memory", cudaErrorInvalidValue and the other
# argument errors.
_CUDA_DEVICE_LOSS = {
    "cudaErrorDevicesUnavailable":
        r"CUDA-capable device\(s\) is/are busy or unavailable",
    "cudaErrorNoDevice": r"no CUDA-capable device is detected",
    "cudaErrorECCUncorrectable": r"uncorrectable ECC error encountered",
    "cudaErrorNvlinkUncorrectable": r"uncorrectable NVLink error",
    "cudaErrorCudartUnloading": r"driver shutting down",
    "cudaErrorSystemNotReady": r"system not yet initialized",
    # NVML_ERROR_GPU_IS_LOST, and the kernel driver's Xid 79 text
    "NVML_ERROR_GPU_IS_LOST": r"GPU is lost|fallen off the bus",
}
_DEVICE_LOSS_PATTERNS = tuple(
    re.compile(p, re.IGNORECASE)
    for p in _JAX_DEVICE_LOSS + tuple(_CUDA_DEVICE_LOSS.values()))


def record_device_lost(site: str) -> None:
    """One definition of the ``elastic_device_lost_total`` counter for
    every detection site (classifier, watchdog escalation) — two literal
    copies would drift apart and split the series. Also the one choke
    point where the flight recorder dumps: a device loss ships with the
    last N trace spans (the dying step/request chain among them)."""
    from .. import monitor as _monitor
    from .. import trace as _trace

    if _monitor.enabled():
        _monitor.counter(
            "elastic_device_lost_total",
            "device losses detected (classified from the runtime's error "
            "zoo, injected, or escalated from a watchdog-diagnosed "
            "parallel-step hang)").labels(site=site).inc()
    _trace.record_incident("device_lost", detail=f"site {site}")


def _chain(exc: BaseException):
    seen = set()
    while exc is not None and id(exc) not in seen:
        seen.add(id(exc))
        yield exc
        exc = exc.__cause__ or exc.__context__


def classify_device_error(exc: BaseException,
                          site: str = "parallel_step"
                          ) -> Optional[DeviceLostError]:
    """Map an exception raised at a parallel-step/collective site onto a
    typed :class:`DeviceLostError`, or ``None`` when it is NOT a device
    loss (shape bugs, transient compile errors, nan trips keep their
    existing recovery paths). Walks the ``__cause__``/``__context__``
    chain so a wrapped runtime error is still recognized; an
    exception that is already a :class:`DeviceLostError` passes through
    unchanged."""
    for e in _chain(exc):
        if isinstance(e, DeviceLostError):
            return e
    for e in _chain(exc):
        # the type gate applies PER CHAIN ELEMENT, like the text match:
        # an Exception-typed wrapper around an XlaRuntimeError must
        # still classify, while a ValueError/TypeError anywhere stays a
        # program bug whatever its message says
        if not isinstance(e, (RuntimeError, OSError, ConnectionError)):
            continue
        text = f"{type(e).__name__}: {e}"
        if any(p.search(text) for p in _DEVICE_LOSS_PATTERNS):
            record_device_lost(site)
            # survivor attribution comes from the element that MATCHED
            # (the runtime's own error) — a wrapper rarely carries it
            return DeviceLostError(
                f"{type(exc).__name__}: {exc}", site=site,
                survivors=(getattr(e, "survivors", None)
                           or getattr(exc, "survivors", None)))
    return None


@contextlib.contextmanager
def device_loss_classification(site: str):
    """Shared dispatch-site wrapper: run the body and re-raise anything
    that classifies as a device loss as the typed
    :class:`DeviceLostError` (chained), leaving every other exception on
    its existing path. One implementation for the parallel-step and
    collective sites, the way ``watchdog_section`` is shared."""
    try:
        yield
    except Exception as e:
        lost = classify_device_error(e, site=site)
        if lost is not None and lost is not e:
            raise lost from e
        raise


# -- 2. mesh rescale planning ----------------------------------------------

def format_axes(axes: Dict[str, int]) -> str:
    """``{'dp': 8, 'pp': 2}`` -> ``"dp=8,pp=2"`` (metric-label form)."""
    return ",".join(f"{k}={v}" for k, v in axes.items()) or "dp=1"


def plan_rescale(old_axes: Dict[str, int], n_devices: int, *,
                 dp_axis: str = "dp", min_dp: int = 1,
                 global_batch: Optional[int] = None) -> Dict[str, int]:
    """Axis sizes for the survivor mesh: every non-dp axis (pp stages, sp
    ring) keeps its size — those axes carry state layout the checkpoint
    depends on — and the dp axis absorbs the loss (or the recovery, when
    ``n_devices`` grew back). Refuses with a typed PT61x
    :class:`ElasticRescaleError` when the surviving topology cannot
    satisfy the non-dp axes (PT610), the dp width would fall below
    ``min_dp`` (PT611), or no feasible dp width divides ``global_batch``
    (PT613 — batch preservation impossible)."""
    old_axes = {str(k): int(v) for k, v in old_axes.items()} or \
        {dp_axis: 1}
    if dp_axis not in old_axes:
        old_axes = {dp_axis: 1, **old_axes}
    non_dp = 1
    for k, v in old_axes.items():
        if k != dp_axis:
            non_dp *= max(1, v)
    if n_devices < non_dp:
        raise ElasticRescaleError(
            "PT610",
            f"mesh axes {format_axes(old_axes)} need {non_dp} device(s) "
            f"for the non-{dp_axis} axes alone, but only {n_devices} "
            f"survive")
    dp = n_devices // non_dp
    if dp < max(1, min_dp):
        raise ElasticRescaleError(
            "PT611",
            f"{n_devices} surviving device(s) over non-{dp_axis} axes "
            f"of {non_dp} leave {dp_axis}={dp} < min {min_dp}")
    if global_batch is not None:
        capacity_dp = dp
        while dp > max(1, min_dp) and int(global_batch) % dp:
            dp -= 1
        if int(global_batch) % dp:
            raise ElasticRescaleError(
                "PT613",
                f"global batch {global_batch} is not divisible by any "
                f"feasible {dp_axis} width <= {n_devices // non_dp} "
                f"(min {min_dp})")
        if dp < capacity_dp:
            # at min_dp=1 a divisor always exists, so the refusal above
            # is only reachable under an explicit floor — but giving up
            # width to divisibility must never be silent: the surplus
            # devices idle until the batch (or min_dp) changes
            logger.warning(
                "elastic: global batch %s is not divisible by %s=%d — "
                "rescaling to %s=%d and leaving %d device(s) idle; set "
                "min_dp (PT613 refusal) or pick a divisible global "
                "batch to reclaim them", global_batch, dp_axis,
                capacity_dp, dp_axis, dp, (capacity_dp - dp) * non_dp)
    new_axes = dict(old_axes)
    new_axes[dp_axis] = dp
    return new_axes


# -- 3. global-batch preservation ------------------------------------------

def grad_accum_steps(old_dp: int, new_dp: int) -> int:
    """Per-replica gradient-accumulation factor that keeps the effective
    global batch after a rescale: each surviving replica processes
    ``ceil(old_dp / new_dp)`` times its previous share inside the fused
    step. Gradients of a mean loss are linear in the batch, so widening
    the per-replica slice is exactly accumulating that many micro-grads
    before one optimizer application."""
    old_dp, new_dp = max(1, int(old_dp)), max(1, int(new_dp))
    return max(1, -(-old_dp // new_dp))


# -- 4. deterministic data resume ------------------------------------------

class DataCursor:
    """The data-pipeline position checkpointed with the model state
    (``meta.json: data_cursor``): epoch index, batches already COMMITTED
    this epoch (consumed by a step whose effect the checkpoint contains),
    and the reader's own resume state (e.g. a seeded shuffle's
    ``state_dict`` — ``reader.shuffle(..., seed=N)``). On restore the
    trainer fast-forwards the reader past ``batch`` batches of epoch
    ``epoch``, so the resumed run sees exactly the not-yet-committed
    batch sequence: batches consumed after the checkpoint but before the
    crash were rolled back with the state and are re-consumed — each
    batch affects the committed lineage exactly once."""

    def __init__(self, epoch: int = 0, batch: int = 0,
                 reader_state: Optional[dict] = None):
        self.epoch = int(epoch)
        self.batch = int(batch)
        self.reader_state = dict(reader_state) if reader_state else None

    def to_dict(self) -> dict:
        d = {"epoch": self.epoch, "batch": self.batch}
        if self.reader_state is not None:
            d["reader_state"] = self.reader_state
        return d

    @classmethod
    def from_dict(cls, d: Optional[dict]) -> Optional["DataCursor"]:
        if not isinstance(d, dict):
            return None
        return cls(epoch=d.get("epoch", 0), batch=d.get("batch", 0),
                   reader_state=d.get("reader_state"))

    def apply_to_reader(self, reader) -> None:
        """Hand the reader its persisted resume state (a no-op for plain
        generator functions — their determinism is positional and the
        trainer's batch skip covers it). A persisted ``epoch`` field is
        realigned to THIS cursor's epoch: the state was captured after
        the reader advanced past the epoch being re-entered, and the
        next ``reader()`` call must replay exactly that epoch's order."""
        if self.reader_state is not None \
                and hasattr(reader, "set_state_dict"):
            state = dict(self.reader_state)
            if "epoch" in state:
                state["epoch"] = self.epoch
            reader.set_state_dict(state)

    @staticmethod
    def capture(epoch: int, batch: int, reader=None) -> "DataCursor":
        state = None
        if reader is not None and hasattr(reader, "state_dict"):
            try:
                state = dict(reader.state_dict())
            except Exception:
                logger.exception(
                    "elastic: reader.state_dict() failed; the cursor "
                    "falls back to positional epoch/batch resume")
        return DataCursor(epoch=epoch, batch=batch, reader_state=state)

    def __repr__(self):
        return (f"DataCursor(epoch={self.epoch}, batch={self.batch}"
                f"{', reader_state=…' if self.reader_state else ''})")


def survivor_devices(devices: Sequence, axes: Dict[str, int]):
    """The device prefix a rescaled mesh uses: ``prod(axes)`` devices in
    enumeration order (stable across the runs of one incarnation — the
    PR 6 restore re-shards state onto whatever mesh exists, so the
    choice only has to be deterministic, not minimal-movement)."""
    n = 1
    for v in axes.values():
        n *= max(1, int(v))
    devices = list(devices)
    if len(devices) < n:
        raise ElasticRescaleError(
            "PT610", f"need {n} device(s) for {format_axes(axes)}, have "
                     f"{len(devices)}")
    return devices[:n]
