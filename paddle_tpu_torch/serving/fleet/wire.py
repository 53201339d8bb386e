"""Fleet wire schema v1: the versioned JSON contract between router,
front-end and callers (docs/SERVING.md "Fleet tier — wire schema"), the
JAX package's byte for byte (``paddle_tpu/serving/fleet/wire.py``).

Everything that crosses the process boundary is defined HERE, once:

* array encoding (base64 raw bytes + dtype + shape — bit-exact, no
  float repr round-trip; numpy arrays or torch tensors, bfloat16
  included),
* the request body (feed/prompt, priority, SLO class, deadline),
* the typed-outcome -> HTTP status map: every one of the engine's typed
  terminal outcomes travels as a DISTINCT status plus a structured error
  body, so a router (or a curl) can tell a shed from an expired deadline
  from a dead bucket without parsing prose,
* trace propagation: the ``X-PT-Trace`` header carries
  ``SpanContext.to_wire()`` so the replica's request root joins the
  caller's trace (one trace id, debuggable fleet-wide via the flight
  recorder),
* error body -> typed exception reconstruction (the router raises the
  SAME classes callers already catch in-process).

``schema_version`` rides in every body; a front-end refuses versions it
does not speak with 400 rather than guessing.
"""
from __future__ import annotations

import base64
import json
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ...resilience.deadline import DeadlineExceeded
from ..engine import (BatchFailed, CircuitOpen, EngineStopped, Overloaded,
                      PoisonRequest, ServingError)

__all__ = [
    "WIRE_SCHEMA_VERSION", "TRACE_HEADER", "SLO_CLASSES",
    "encode_array", "decode_array", "encode_feed", "decode_feed",
    "status_for", "error_body", "error_from_body", "resolve_priority",
    "resolve_tenant", "response_is_unadmitted", "ReplicaLost",
    "WireError",
]

WIRE_SCHEMA_VERSION = 1

# request header carrying trace.SpanContext.to_wire() across the wire
TRACE_HEADER = "X-PT-Trace"

# SLO classes resolve to admission priorities when the caller does not
# pass an explicit priority (degraded-mode shedding keys on priority —
# docs/SERVING.md). Deployments with finer tiers pass priority directly.
SLO_CLASSES: Dict[str, int] = {"batch": 0, "standard": 1,
                               "interactive": 2}


class WireError(ValueError):
    """Malformed/unsupported wire payload (HTTP 400 — a caller bug, not
    a submitted request; it never enters any accounting)."""


class ReplicaLost(ServingError):
    """The replica's connection failed while it held (or may have held)
    this request: either the connection died after the request bytes
    went out (the replica may have admitted it — never retried, because
    a possibly-admitted request retried elsewhere could reach TWO
    outcomes), or no replica could be reached at all once the retry
    policy was exhausted. Always a typed terminal outcome, never a bare
    socket error."""

    def __init__(self, msg: str, replica: str = ""):
        self.replica = replica
        super().__init__(msg)


# ---------------------------------------------------------------------------
# arrays
# ---------------------------------------------------------------------------

def encode_array(a) -> dict:
    """``{dtype, shape, b64}`` of a numpy array or a torch tensor (on any
    device). A bfloat16 tensor travels as its raw 2-byte words under the
    dtype name ``bfloat16``: the bytes the JAX package sends for the same
    values."""
    if isinstance(a, torch.Tensor):
        t = a.detach().contiguous().cpu()
        if t.dtype == torch.bfloat16:
            return {"dtype": "bfloat16", "shape": list(t.shape),
                    "b64": base64.b64encode(
                        t.view(torch.int16).numpy().tobytes()
                    ).decode("ascii")}
        a = t.numpy()
    a = np.ascontiguousarray(np.asarray(a))
    return {"dtype": str(a.dtype), "shape": list(a.shape),
            "b64": base64.b64encode(a.tobytes()).decode("ascii")}


def decode_array(d):
    """The numpy array of an encoded payload; a ``bfloat16`` payload
    decodes to a CPU ``torch.bfloat16`` tensor where numpy has no such
    dtype (it has one only with ``ml_dtypes`` imported)."""
    if not isinstance(d, dict) or "b64" not in d:
        raise WireError(f"array payload must be "
                        f"{{dtype, shape, b64}}, got {type(d).__name__}")
    try:
        shape = [int(x) for x in d["shape"]]
        raw = base64.b64decode(d["b64"])
        if d["dtype"] == "bfloat16" and not _numpy_knows("bfloat16"):
            words = np.frombuffer(raw, dtype=np.int16).reshape(shape)
            return torch.from_numpy(words.copy()).view(torch.bfloat16)
        a = np.frombuffer(raw, dtype=np.dtype(d["dtype"]))
        return a.reshape(shape).copy()
    except WireError:
        raise
    except Exception as e:
        raise WireError(f"undecodable array payload "
                        f"({type(e).__name__}: {e})") from e


def _numpy_knows(name: str) -> bool:
    try:
        np.dtype(name)
    except TypeError:
        return False
    return True


def encode_feed(feed: Dict[str, Any]) -> dict:
    return {n: encode_array(v) for n, v in feed.items()}


def decode_feed(d) -> Dict[str, np.ndarray]:
    if not isinstance(d, dict):
        raise WireError("feed must be a JSON object of name -> array")
    return {str(n): decode_array(v) for n, v in d.items()}


def resolve_priority(body: dict) -> int:
    """Explicit ``priority`` wins; else the ``slo_class`` mapping; else
    the standard tier."""
    if body.get("priority") is not None:
        return int(body["priority"])
    slo = body.get("slo_class")
    if slo is None:
        return SLO_CLASSES["standard"]
    if slo not in SLO_CLASSES:
        raise WireError(f"unknown slo_class {slo!r} "
                        f"(known: {sorted(SLO_CLASSES)})")
    return SLO_CLASSES[slo]


# accounting tenants become metric label values (fleet_tenant_*); the
# charset bound keeps hostile ids out of the exposition format and the
# length bound keeps one caller from exploding label cardinality storage
_TENANT_MAX_LEN = 64


def resolve_tenant(body: dict) -> Optional[str]:
    """The optional ``tenant`` field (wire schema v1, additive): a short
    accounting id string, validated here so a hostile value is a 400
    ``WireError`` — a caller bug, never a submitted request. ``None``
    when absent (the engine accounts it under its default tenant)."""
    tenant = body.get("tenant")
    if tenant is None:
        return None
    if not isinstance(tenant, str):
        raise WireError(f"tenant must be a string, "
                        f"got {type(tenant).__name__}")
    tenant = tenant.strip()
    if not tenant:
        return None
    if len(tenant) > _TENANT_MAX_LEN:
        raise WireError(f"tenant id longer than {_TENANT_MAX_LEN} chars")
    if not all(c.isalnum() or c in "-_.:@" for c in tenant):
        raise WireError(
            "tenant id may only contain alphanumerics and - _ . : @ "
            f"(got {tenant!r})")
    return tenant


# ---------------------------------------------------------------------------
# typed outcomes <-> HTTP
# ---------------------------------------------------------------------------

# every typed terminal outcome maps to a DISTINCT status — the router's
# admitted/unadmitted classification reads the status alone:
#   400 caller bug (never submitted)    429 shed at admission (unadmitted)
#   410 engine stopped/draining at
#       admission (unadmitted)          503 bucket quarantined
#   500 batch failed (admitted)         504 deadline exceeded (admitted)
_STATUS = (
    (Overloaded, 429),
    (CircuitOpen, 503),
    (EngineStopped, 410),
    (DeadlineExceeded, 504),
    (BatchFailed, 500),
    (WireError, 400),
)

# statuses a router may retry on a sibling when the error body does not
# say better: the replica normally REJECTED such a request at admission,
# so it reached no outcome there. The body's explicit "admitted" flag
# (set by the front-end, which knows whether submit() itself raised)
# always wins — an ADMITTED request that settled EngineStopped (engine
# stopped without drain, dispatch-thread crash) also travels as 410, and
# retrying it would give one request two outcomes.
UNADMITTED_STATUSES = frozenset({429, 410})


def response_is_unadmitted(status: int, body: Optional[dict]) -> bool:
    """May the router retry this response on a sibling? The front-end's
    explicit ``admitted`` flag is authoritative; the status-class map is
    the fallback for bodies that lack it."""
    err = (body or {}).get("error") or {}
    if "admitted" in err:
        return err["admitted"] is False
    return status in UNADMITTED_STATUSES


def status_for(exc: BaseException) -> int:
    for cls, code in _STATUS:
        if isinstance(exc, cls):
            return code
    if isinstance(exc, ValueError):
        return 400
    return 500


def error_body(exc: BaseException,
               admitted: Optional[bool] = None) -> dict:
    """The structured error body for a typed outcome (or a caller bug).
    Carries enough to reconstruct the SAME typed exception router-side.
    ``admitted`` records whether the request had been admitted when the
    error arose (the front-end knows; the router's retry policy reads
    it — see :func:`response_is_unadmitted`)."""
    err: Dict[str, Any] = {
        "type": type(exc).__name__,
        "message": str(exc),
        "trace_id": getattr(exc, "trace_id", "") or "",
        "transient": bool(getattr(exc, "transient", False)),
    }
    if admitted is not None:
        err["admitted"] = bool(admitted)
    if isinstance(exc, Overloaded):
        err["reason"] = exc.reason
    if isinstance(exc, CircuitOpen):
        err["bucket"] = exc.bucket
    if isinstance(exc, DeadlineExceeded):
        err.update(what=exc.what, budget_s=exc.budget_s,
                   elapsed_s=exc.elapsed_s)
    if isinstance(exc, PoisonRequest):
        err["fingerprint"] = exc.fingerprint
    if isinstance(exc, ReplicaLost):
        err["replica"] = exc.replica
    return {"schema_version": WIRE_SCHEMA_VERSION, "error": err}


def error_from_body(body: Optional[dict],
                    default_msg: str = "") -> BaseException:
    """Rebuild the typed exception a replica shipped (the router raises
    it locally, trace id intact). Unknown/missing types degrade to the
    ``ServingError`` base — still typed, never a bare RuntimeError."""
    err = (body or {}).get("error") or {}
    typ = err.get("type", "")
    msg = err.get("message") or default_msg or "remote serving error"
    if typ == "Overloaded":
        e: BaseException = Overloaded(msg,
                                      reason=err.get("reason", "remote"))
    elif typ == "CircuitOpen":
        e = CircuitOpen(msg, bucket=err.get("bucket", ""))
    elif typ == "EngineStopped":
        e = EngineStopped(msg)
    elif typ == "DeadlineExceeded":
        e = DeadlineExceeded(err.get("what", msg),
                             float(err.get("budget_s", 0.0)),
                             float(err.get("elapsed_s", 0.0)))
    elif typ == "PoisonRequest":
        # still travels as 500 (a BatchFailed subclass), but the caller
        # can tell "you poisoned the batch" from "the bucket is broken"
        e = PoisonRequest(msg, fingerprint=err.get("fingerprint", ""))
    elif typ == "BatchFailed":
        e = BatchFailed(msg)
    elif typ == "ReplicaLost":
        e = ReplicaLost(msg, replica=err.get("replica", ""))
    elif typ in ("WireError", "ValueError"):
        # the 400 class: a caller bug the replica never submitted —
        # surfaced as the same ValueError family it is in-process
        e = WireError(msg)
    else:
        e = ServingError(f"{typ or 'remote error'}: {msg}")
    tid = err.get("trace_id", "")
    if tid:
        e.trace_id = tid
    return e


# ---------------------------------------------------------------------------
# body plumbing
# ---------------------------------------------------------------------------

def dumps(obj) -> bytes:
    return json.dumps(obj).encode("utf-8")


def loads(raw: bytes) -> dict:
    try:
        obj = json.loads(raw.decode("utf-8"))
    except Exception as e:
        raise WireError(f"request body is not JSON "
                        f"({type(e).__name__}: {e})") from e
    if not isinstance(obj, dict):
        raise WireError("request body must be a JSON object")
    v = obj.get("schema_version", WIRE_SCHEMA_VERSION)
    try:
        v = int(v)
    except (TypeError, ValueError):
        raise WireError(f"wire schema_version must be an integer, "
                        f"got {v!r}") from None
    if v > WIRE_SCHEMA_VERSION:
        raise WireError(f"wire schema_version {v} is newer than this "
                        f"front-end speaks ({WIRE_SCHEMA_VERSION})")
    return obj


def encode_outputs(outs: List[np.ndarray], trace_id: str = "") -> dict:
    return {"schema_version": WIRE_SCHEMA_VERSION,
            "outputs": [encode_array(o) for o in outs],
            "trace_id": trace_id}


def decode_outputs(body: dict) -> List[np.ndarray]:
    return [decode_array(o) for o in body.get("outputs", ())]
