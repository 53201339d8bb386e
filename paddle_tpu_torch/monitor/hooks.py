"""Event-hook API: subscribe to executor lifecycle events.

``add_hook(on_step_begin=..., on_step_end=..., on_compile=...)`` lets
trainers and serving wrappers observe execution without patching the
executor: three typed events fed by ``Executor.run`` / ``run_chained``
(a copy of ``paddle_tpu/monitor/hooks.py``, same record fields).

Hook failures are contained: a raising hook is logged and skipped, never
allowed to break a training step.
"""
from __future__ import annotations

import dataclasses
import logging
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

from .lockwitness import make_lock

__all__ = ["StepRecord", "CompileRecord", "Hook", "add_hook", "remove_hook",
           "clear_hooks", "dispatch"]

log = logging.getLogger("paddle_tpu_torch.monitor")


@dataclasses.dataclass
class StepRecord:
    """One executor step (``path``: run | chained | parallel)."""

    path: str
    program_serial: int
    step_index: int = 0
    cache_hit: Optional[bool] = None
    iterations: int = 1              # run_chained: scanned steps per dispatch
    duration_s: Optional[float] = None
    feed_bytes: int = 0              # host->device transfer this step
    fetch_bytes: int = 0             # device->host transfer this step
    donated_buffers: int = 0         # state vars written in place
    kept_buffers: int = 0            # state vars read only
    donated_bytes: int = 0           # live bytes of the in-place state
    batch_rows: int = 0              # leading feed dim (cost-model batch)
    fetch_names: Tuple[str, ...] = ()

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class CompileRecord:
    """One compile-cache miss (fresh compile or recompilation)."""

    path: str
    program_serial: int
    build_site: str                  # op_callstack of the program's first op
    components: Dict[str, Any]       # the cache-key components
    recompile: bool                  # program serial was compiled before
    changed: Tuple[str, ...]         # key components that differ vs last time
    n_compiles: int                  # compiles of this program so far (>=1)
    detail: str = ""                 # human diff, e.g. old->new feed sig
    donated_bytes_est: int = 0       # static estimate (memory_plan sizes)
    trace_lower_s: Optional[float] = None   # preparation (fusion pass)
    compile_s: Optional[float] = None       # 0.0: the port compiles nothing

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        # components may hold tuples of tuples; keep them JSON-friendly
        d["components"] = {k: repr(v) for k, v in self.components.items()}
        return d


class Hook:
    """Handle returned by ``add_hook``; pass to ``remove_hook``."""

    def __init__(self, on_step_begin=None, on_step_end=None, on_compile=None):
        self.on_step_begin = on_step_begin
        self.on_step_end = on_step_end
        self.on_compile = on_compile


_lock = make_lock("monitor.hooks._lock")
_hooks: List[Hook] = []


def add_hook(on_step_begin: Optional[Callable[[StepRecord], None]] = None,
             on_step_end: Optional[Callable[[StepRecord], None]] = None,
             on_compile: Optional[Callable[[CompileRecord], None]] = None,
             ) -> Hook:
    hook = Hook(on_step_begin, on_step_end, on_compile)
    with _lock:
        _hooks.append(hook)
    return hook


def remove_hook(hook: Hook) -> None:
    with _lock:
        try:
            _hooks.remove(hook)
        except ValueError:
            pass


def clear_hooks() -> None:
    with _lock:
        _hooks.clear()


def dispatch(event: str, record) -> None:
    """Fire one event ('step_begin' | 'step_end' | 'compile') at every
    subscribed hook; exceptions are logged, never propagated."""
    with _lock:
        hooks = list(_hooks)
    for h in hooks:
        fn = getattr(h, "on_" + event, None)
        if fn is None:
            continue
        try:
            fn(record)
        except Exception:
            log.exception("monitor hook %s raised; the event was skipped "
                          "for this hook but it stays subscribed — "
                          "remove_hook() to silence it", event)
