"""Recompilation diagnostics: explain *why* a cached program recompiled.

A copy of ``paddle_tpu/monitor/recompile.py``. The port interprets
programs op by op and builds no executable; its compile event is the
first run of an executor key (see ``executor.py``). This tracker watches
every such event: for a program already seen it diffs the key components
(program version/op-count, feed signature, fetch list, scope serial,
flags) against the previous event and names exactly what changed,
attributed to the program's build site (the ``op_callstack`` of its first
user-built op).

Logging contract (``FLAGS_log_compiles``-style):
  * ``FLAGS_log_compiles=1`` — every compile logs INFO, every recompile
    logs WARNING with the component diff.
  * always — after ``FLAGS_recompile_warn_threshold`` recompiles of the
    same program (default 3), a WARNING fires regardless of the flag: this
    is the "your serving loop recompiles every request" tripwire.

Events are retained in a bounded ring (``events()``).
"""
from __future__ import annotations

import collections
import logging
import threading
from typing import Any, Dict, List, Optional, Tuple

from .hooks import CompileRecord
from .lockwitness import make_lock

__all__ = ["RecompileTracker", "build_site", "get_tracker"]

log = logging.getLogger("paddle_tpu_torch.monitor")

_MAX_EVENTS = 256
# per-(program, path) compile history cap: a server that builds a fresh
# Program per request must not leak one tracker entry per request forever
_MAX_PROGRAMS = 4096


def build_site(program) -> str:
    """The user line that built the program: the first global-block op
    carrying an ``op_callstack`` attr (reference op_call_stack.h — ops
    remember their creation site; the program inherits its first op's)."""
    try:
        for op in program.global_block.ops:
            site = op.attrs.get("op_callstack")
            if site:
                return str(site)
    except Exception:
        pass
    return "<unknown build site>"


def _diff_detail(name: str, old, new) -> str:
    """Compact old->new rendering for one changed component. Feed
    signatures diff per feed name so the message points at the tensor."""
    if name == "feed_signature":
        old_map = {e[0]: e[1:] for e in (old or ())}
        new_map = {e[0]: e[1:] for e in (new or ())}
        parts = []
        for k in sorted(set(old_map) | set(new_map)):
            o, n = old_map.get(k), new_map.get(k)
            if o != n:
                parts.append(f"'{k}': {o} -> {n}")
        if parts:
            return f"{name}[{'; '.join(parts)}]"
    return f"{name}: {old!r} -> {new!r}"


class RecompileTracker:
    def __init__(self):
        self._lock = make_lock("RecompileTracker._lock")
        # (program serial, path) -> (n_compiles, last components, site).
        # Keyed per path: run and run_chained build different executable
        # kinds with different key components — crossing them would report
        # phantom recompiles on the first chained call of a run program.
        self._programs: Dict[Tuple[int, str],
                             Tuple[int, Dict[str, Any], str]] = {}
        self._events = collections.deque(maxlen=_MAX_EVENTS)

    def observe(self, path: str, program_serial: int, site: str,
                components: Dict[str, Any]) -> CompileRecord:
        """Record one compile-cache miss; returns the CompileRecord (with
        ``recompile``/``changed``/``detail`` filled, timings still None)."""
        from ..flags import flag

        with self._lock:
            prev = self._programs.pop((program_serial, path), None)
            n = 1 if prev is None else prev[0] + 1
            # pop-then-insert keeps the dict LRU-ordered by last compile,
            # so eviction drops the LEAST recently compiling program, not
            # the hot one this tracker exists to watch
            self._programs[(program_serial, path)] = (n, dict(components),
                                                      site)
            while len(self._programs) > _MAX_PROGRAMS:
                # an evicted program that recompiles later reads as a
                # fresh compile — acceptable for a bounded diagnostic
                self._programs.pop(next(iter(self._programs)))
        if prev is None:
            rec = CompileRecord(path=path, program_serial=program_serial,
                                build_site=site, components=dict(components),
                                recompile=False, changed=(), n_compiles=n)
        else:
            _, last, _ = prev
            changed = tuple(k for k in components
                            if components.get(k) != last.get(k))
            detail = "; ".join(_diff_detail(k, last.get(k),
                                            components.get(k))
                               for k in changed)
            if not changed:
                detail = ("identical cache key — compiled step evicted or "
                          "use_program_cache=False")
            rec = CompileRecord(path=path, program_serial=program_serial,
                                build_site=site, components=dict(components),
                                recompile=True, changed=changed,
                                n_compiles=n, detail=detail)
        with self._lock:
            self._events.append(rec)

        n_recompiles = n - 1
        if rec.recompile:
            msg = (f"recompilation #{n_recompiles} of program "
                   f"{program_serial} (built at {rec.build_site}) on the "
                   f"'{path}' path — cache-key changed in "
                   f"{', '.join(rec.changed) or 'nothing'}: {rec.detail}")
            threshold = int(flag("recompile_warn_threshold"))
            if flag("log_compiles"):
                log.warning(msg)
            elif threshold and n_recompiles == threshold:
                log.warning(
                    "%s — this program has now recompiled %d times; each "
                    "new key re-runs the preparation (fusion pass) "
                    "(set FLAGS_log_compiles=1 to log each one)",
                    msg, n_recompiles)
        elif flag("log_compiles"):
            log.info("compiling program %s (built at %s) on the '%s' path",
                     program_serial, rec.build_site, path)
        return rec

    def recompile_count(self, program_serial: Optional[int] = None) -> int:
        with self._lock:
            return sum(max(0, n - 1)
                       for (serial, _), (n, _, _) in self._programs.items()
                       if program_serial is None or serial == program_serial)

    def events(self, recompiles_only: bool = False) -> List[CompileRecord]:
        with self._lock:
            evs = list(self._events)
        return [e for e in evs if e.recompile] if recompiles_only else evs

    def reset(self) -> None:
        with self._lock:
            self._programs.clear()
            self._events.clear()


_tracker = RecompileTracker()


def get_tracker() -> RecompileTracker:
    return _tracker
