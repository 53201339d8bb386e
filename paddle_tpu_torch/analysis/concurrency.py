"""Source-level concurrency static analysis, the PT800 family
(counterpart of ``paddle_tpu/analysis/concurrency.py``, over the port's
own source).

The executor, the serving dispatch threads and the fleet router,
supervisor and autoscaler are free-threaded Python holding some thirty
lock sites. This module is an ``ast``-based analysis over the
``paddle_tpu_torch`` *source itself*, in the same diagnostic idiom as the
Program-IR passes but over Python functions instead of IR ops.

What it builds per module tree:

* a **lock inventory** — every ``threading.Lock/RLock/Condition`` (and
  ``Event``) attribute, module-level lock, per-key lock kept in a dict
  (``d.setdefault(key, threading.Lock())``: one node for the dict), and
  every lock created through the witness factories
  ``monitor.lockwitness.make_lock/make_rlock/make_condition`` (whose
  string-literal name becomes the lock's canonical id, so static and
  runtime names agree);
* a **lock-order graph** — edges ``A -> B`` wherever ``B`` is acquired
  (directly by a nested ``with``, or transitively through a resolved
  call) while ``A`` is held.  ``threading.Condition(lock)`` aliases to
  its underlying lock, so ``with self._work:`` and ``with self._lock:``
  are one node;
* three diagnostics:

  ========  ==========================================================
  PT800     cycle in the lock-order graph (incl. re-acquiring a
            non-reentrant ``Lock`` through a call chain)
  PT801     blocking call while holding a lock: ``time.sleep``,
            socket/HTTP I/O, ``subprocess`` waits, ``Event.wait()``
            without timeout, ``Thread.join()`` without timeout,
            ``torch.cuda.synchronize`` and ``synchronize()`` on a CUDA
            stream or event, unbounded ``queue`` ops — found directly or
            through the call-graph approximation
  PT802     attribute of a thread-spawning class reachable from more
            than one thread entry point, written at least once, with
            at least one access outside any lock region
  ========  ==========================================================

The device waits: ``torch.cuda.synchronize`` waits for every stream of
the device, work that other threads enqueued included, so under a lock
it stalls every thread that needs the lock for as long as the whole
card is busy; a stream's or an event's ``synchronize()`` waits for all
that was enqueued on that stream before it. A host read of a tensor
(``.item()``, ``.cpu()``, ``.numpy()``, ``.tolist()``) is not counted:
it waits only for the work that produces the value read, which is the
work the thread holding the lock is doing anyway, and its receiver cannot
be typed from the source (numpy arrays and Python numbers answer the
same method names), so flagging the name alone would report every numpy
read.

The analysis is deliberately an *approximation*: calls are resolved by
name through ``self``-methods, annotated attribute/parameter types,
local constructor assignments and intra-package module aliases;
unresolved calls are ignored (no finding is better than a speculative
one — the runtime lock witness covers the gap from the other side, see
``paddle_tpu_torch.monitor.lockwitness``). A call through a
``torch.library`` custom op (``torch.ops.<ns>.<op>``) is one such
unresolved call: the locks behind it (the kernel build and launch-count
locks of ``kernels/_build.py``) are plain ``threading`` locks, which the
witness does not instrument, so no runtime edge can reach them that this
graph would have to predict. Findings carry a stable ``key`` in
``Diagnostic.op_type`` so ``tools/torch_lint_concurrency.py`` can match
its allowlist on ``(code, key)``.
"""
from __future__ import annotations

import ast
import dataclasses
import os
from typing import Dict, List, Optional, Sequence, Set, Tuple

from ..monitor.lockwitness import _find_cycles
from .diagnostics import Diagnostic

__all__ = [
    "LockDef", "LockEdge", "ConcurrencyReport",
    "analyze_paths", "analyze_package", "static_edge_set",
    "package_source_files",
]

# fully-qualified module functions that block the calling thread
_BLOCKING_FUNCS = {
    "time.sleep": "time.sleep",
    "subprocess.run": "subprocess.run",
    "subprocess.call": "subprocess.call",
    "subprocess.check_call": "subprocess.check_call",
    "subprocess.check_output": "subprocess.check_output",
    "socket.create_connection": "socket.create_connection",
    "urllib.request.urlopen": "urllib.request.urlopen",
    "select.select": "select.select",
    "os.system": "os.system",
    "torch.cuda.synchronize": "torch.cuda.synchronize",
}

# receiver kinds inferred for attribute calls; method names that block
_BLOCKING_METHODS = {
    "popen": ("wait", "communicate"),
    "thread": ("join",),
    "queue": ("get", "put", "join"),
    "socket": ("connect", "accept", "recv", "sendall", "makefile"),
    "httpconn": ("connect", "request", "getresponse"),
    "httpresp": ("read",),
    "cudaevent": ("synchronize",),
    "cudastream": ("synchronize",),
}

# ``torch.cuda.<name>(...)`` calls that make a CUDA receiver: kind and
# the pseudo class name an attribute holding one is typed with
_CUDA_CTORS = {"Event": ("cudaevent", "CudaEvent"),
               "Stream": ("cudastream", "CudaStream"),
               "current_stream": ("cudastream", "CudaStream"),
               "default_stream": ("cudastream", "CudaStream")}

_LOCK_KINDS = ("lock", "rlock", "condition")


@dataclasses.dataclass
class LockDef:
    """One named lock site (an attribute, module global or factory call)."""
    id: str                    # canonical name (witness literal when present)
    kind: str                  # lock | rlock | condition | event | unknown
    module: str
    cls: Optional[str]
    attr: str
    line: int
    reentrant: bool
    alias_of: Optional[str] = None   # Condition(lock): underlying lock id

    @property
    def node(self) -> str:
        """Graph node this site acquires (conditions collapse onto their
        underlying lock)."""
        return self.alias_of or self.id


@dataclasses.dataclass
class LockEdge:
    src: str
    dst: str
    site: str      # file:line of the inner acquisition
    via: str = ""  # call chain when the edge crosses a function boundary


@dataclasses.dataclass
class ConcurrencyReport:
    locks: Dict[str, LockDef]
    edges: List[LockEdge]
    diagnostics: List[Diagnostic]
    modules: List[str]
    functions: int

    def edge_set(self) -> Set[Tuple[str, str]]:
        return {(e.src, e.dst) for e in self.edges}

    def to_dict(self) -> dict:
        return {
            "modules": list(self.modules),
            "functions": self.functions,
            "locks": {
                lid: {"kind": d.kind, "module": d.module, "class": d.cls,
                      "attr": d.attr, "line": d.line,
                      "reentrant": d.reentrant, "alias_of": d.alias_of}
                for lid, d in sorted(self.locks.items())
            },
            "edges": [{"src": e.src, "dst": e.dst, "site": e.site,
                       "via": e.via}
                      for e in sorted(self.edges,
                                      key=lambda e: (e.src, e.dst, e.site))],
            "diagnostics": [
                {"code": d.code, "severity": d.severity, "key": d.op_type,
                 "message": d.message, "site": d.site}
                for d in self.diagnostics
            ],
        }


# --------------------------------------------------------------------------
# per-module collection
# --------------------------------------------------------------------------

@dataclasses.dataclass
class _FuncInfo:
    key: Tuple[str, Optional[str], str]   # (module, class, name)
    site: str
    # events recorded during the body walk
    acquires: List[Tuple[Tuple[str, ...], str, str]] = \
        dataclasses.field(default_factory=list)      # (held, node, site)
    calls: List[Tuple[Tuple[str, ...], Tuple, str]] = \
        dataclasses.field(default_factory=list)      # (held, callee, site)
    blocking: List[Tuple[Tuple[str, ...], str, str]] = \
        dataclasses.field(default_factory=list)      # (held, what, site)
    attr_events: List[Tuple[str, bool, bool, str]] = \
        dataclasses.field(default_factory=list)  # (attr, write, locked, site)
    thread_targets: List[Tuple[Tuple, str]] = \
        dataclasses.field(default_factory=list)      # (callee key, site)

    @property
    def qualname(self) -> str:
        mod, cls, name = self.key
        return f"{mod}.{cls}.{name}" if cls else f"{mod}.{name}"


@dataclasses.dataclass
class _ClassInfo:
    module: str
    name: str
    bases: List[str]
    locks: Dict[str, LockDef] = dataclasses.field(default_factory=dict)
    attr_types: Dict[str, str] = dataclasses.field(default_factory=dict)
    methods: Dict[str, _FuncInfo] = dataclasses.field(default_factory=dict)
    prop_types: Dict[str, str] = dataclasses.field(default_factory=dict)
    # attr -> the class of the elements it holds (``List[X]`` and kin)
    elem_types: Dict[str, str] = dataclasses.field(default_factory=dict)
    # the constructor's parameters in order, their annotated classes, the
    # attrs stored straight from an unannotated one (attr -> param) and
    # the attrs that fall back to another param's attr (attr -> (param,
    # its attr)): typed after every module is read
    # (``_Analyzer.type_ctor_params``)
    init_params: List[str] = dataclasses.field(default_factory=list)
    init_ann: Dict[str, str] = dataclasses.field(default_factory=dict)
    param_attrs: Dict[str, str] = dataclasses.field(default_factory=dict)
    attr_refs: Dict[str, Tuple[str, str]] = \
        dataclasses.field(default_factory=dict)


class _ModuleCollector:
    """First pass over one module: imports, classes, lock inventory."""

    def __init__(self, module: str, relpath: str, tree: ast.Module,
                 is_package: bool = False):
        self.module = module
        self.relpath = relpath
        self.tree = tree
        self.is_package = is_package
        self.imports: Dict[str, str] = {}     # local alias -> dotted module
        self.symbols: Dict[str, Tuple[str, str]] = {}  # name -> (module, sym)
        self.classes: Dict[str, _ClassInfo] = {}
        self.module_locks: Dict[str, LockDef] = {}
        self.module_funcs: Dict[str, ast.AST] = {}
        self.module_instances: Dict[str, str] = {}  # global -> class name

    def collect(self):
        # imports are collected from the WHOLE tree (function-level
        # lazy imports are the repo's cycle-avoidance idiom and still
        # name lock-owning modules, e.g. the engine's late
        # ``from ..resilience import graceful as _graceful``)
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    self.imports[a.asname or a.name.split(".")[0]] = (
                        a.name if a.asname else a.name.split(".")[0])
            elif isinstance(node, ast.ImportFrom):
                base = self._resolve_from(node)
                for a in node.names:
                    if a.name == "*":
                        continue
                    self.symbols[a.asname or a.name] = (base, a.name)
        for node in self.tree.body:
            if isinstance(node, ast.ClassDef):
                self._collect_class(node)
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.module_funcs[node.name] = node
            elif isinstance(node, ast.Assign):
                self._module_lock(node)
        for node in ast.walk(self.tree):
            self._keyed_lock(node)

    def _resolve_from(self, node: ast.ImportFrom) -> str:
        if node.level == 0:
            return node.module or ""
        parts = self.module.split(".")
        # a package __init__ IS its own level-1 base: ``from .hooks
        # import dispatch`` in monitor/__init__.py means monitor.hooks,
        # not a sibling of monitor
        strip = node.level - (1 if self.is_package else 0)
        base = parts[:len(parts) - strip] if strip else parts
        if node.module:
            base.append(node.module)
        return ".".join(base)

    # -- lock/type inventory ---------------------------------------------

    def _module_lock(self, node: ast.Assign):
        if len(node.targets) != 1 or not isinstance(node.targets[0], ast.Name):
            return
        name = node.targets[0].id
        info = self._lock_expr(node.value, None)
        if info is None:
            # module-level singleton: ``_collector = SpanCollector()`` —
            # method calls on the global resolve to the class
            t = _ctor_class(node.value)
            if t:
                self.module_instances[name] = t
            return
        kind, reentrant, literal, alias = info
        lid = literal or f"{self.module}.{name}"
        self.module_locks[name] = LockDef(
            id=lid, kind=kind, module=self.module, cls=None, attr=name,
            line=node.lineno, reentrant=reentrant, alias_of=alias)

    def _keyed_lock(self, node):
        """``d.setdefault(key, threading.Lock())`` on a module global
        ``d``: one lock per key, inventoried as the one node ``d[]``."""
        if not (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "setdefault"
                and isinstance(node.func.value, ast.Name)
                and len(node.args) == 2):
            return
        info = self._lock_expr(node.args[1], None)
        if info is None:
            return
        kind, reentrant, literal, alias = info
        key = f"{node.func.value.id}[]"
        self.module_locks.setdefault(key, LockDef(
            id=literal or f"{self.module}.{key}", kind=kind,
            module=self.module, cls=None, attr=key, line=node.lineno,
            reentrant=reentrant, alias_of=alias))

    def _collect_class(self, node: ast.ClassDef):
        ci = _ClassInfo(module=self.module, name=node.name,
                        bases=[b.id for b in node.bases
                               if isinstance(b, ast.Name)])
        self.classes[node.name] = ci
        for stmt in node.body:
            if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 \
                    and isinstance(stmt.targets[0], ast.Name):
                # class-level lock (shared across instances)
                info = self._lock_expr(stmt.value, ci)
                if info:
                    kind, reentrant, literal, alias = info
                    attr = stmt.targets[0].id
                    lid = literal or f"{self.module}.{node.name}.{attr}"
                    ci.locks[attr] = LockDef(
                        id=lid, kind=kind, module=self.module, cls=node.name,
                        attr=attr, line=stmt.lineno, reentrant=reentrant,
                        alias_of=alias)
            elif isinstance(stmt, ast.AnnAssign) \
                    and isinstance(stmt.target, ast.Name):
                # annotated class field (dataclass idiom): the annotation
                # types the attr — `future: ServingFuture` is how the
                # request record names its future, and resolving
                # r.future._settle() through it is what lets the static
                # graph predict the ServingEngine._lock ->
                # ServingFuture._lock runtime edge
                t = _ann_class(stmt.annotation)
                if t:
                    ci.attr_types.setdefault(stmt.target.id, t)
            elif isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                is_prop = any(
                    (isinstance(d, ast.Name) and d.id == "property")
                    or (isinstance(d, ast.Attribute) and d.attr in
                        ("property", "cached_property"))
                    for d in stmt.decorator_list)
                if is_prop and stmt.returns is not None:
                    t = _ann_class(stmt.returns)
                    if t:
                        ci.prop_types[stmt.name] = t
                self._scan_method_attrs(ci, stmt)

    def _scan_method_attrs(self, ci: _ClassInfo, fn):
        """self.X = threading.Lock()/make_lock(...)/ClassName(...)/param."""
        ann: Dict[str, str] = {}
        for arg in list(fn.args.args) + list(fn.args.kwonlyargs):
            if arg.annotation is not None:
                t = _ann_class(arg.annotation)
                if t:
                    ann[arg.arg] = t
        params = [a.arg for a in list(fn.args.args)[1:]
                  + list(fn.args.kwonlyargs)]
        if fn.name == "__init__":
            ci.init_params = [a.arg for a in list(fn.args.args)[1:]]
            ci.init_ann = dict(ann)
        for sub in ast.walk(fn):
            if isinstance(sub, ast.AnnAssign) \
                    and isinstance(sub.target, ast.Attribute) \
                    and isinstance(sub.target.value, ast.Name) \
                    and sub.target.value.id == "self":
                # self.replicas: List[Replica] = []
                elem = _elem_class(sub.annotation)
                if elem:
                    ci.elem_types.setdefault(sub.target.attr, elem)
                else:
                    t = _ann_class(sub.annotation)
                    if t:
                        ci.attr_types.setdefault(sub.target.attr, t)
                continue
            if not (isinstance(sub, ast.Assign) and len(sub.targets) == 1):
                continue
            tgt = sub.targets[0]
            if not (isinstance(tgt, ast.Attribute)
                    and isinstance(tgt.value, ast.Name)
                    and tgt.value.id == "self"):
                continue
            attr = tgt.attr
            info = self._lock_expr(sub.value, ci)
            if info:
                kind, reentrant, literal, alias = info
                if attr not in ci.locks:
                    lid = literal or f"{self.module}.{ci.name}.{attr}"
                    ci.locks[attr] = LockDef(
                        id=lid, kind=kind, module=self.module, cls=ci.name,
                        attr=attr, line=sub.lineno, reentrant=reentrant,
                        alias_of=alias)
                continue
            # self.x = ClassName(...)
            t = _ctor_class(sub.value)
            if t:
                ci.attr_types.setdefault(attr, t)
                continue
            # self.x = p if p is not None else getattr(q, "x", None): p's
            # type, else the type q's class gives its attr "x"
            value = sub.value
            if isinstance(value, ast.IfExp) \
                    and isinstance(value.body, ast.Name) \
                    and value.body.id in params:
                ref = value.orelse
                if isinstance(ref, ast.Call) and _dotted(ref.func) == \
                        "getattr" and len(ref.args) >= 2 \
                        and isinstance(ref.args[0], ast.Name) \
                        and ref.args[0].id in params \
                        and isinstance(ref.args[1], ast.Constant) \
                        and isinstance(ref.args[1].value, str):
                    ci.attr_refs.setdefault(
                        attr, (ref.args[0].id, ref.args[1].value))
                value = value.body
            # self.x = param  (annotated, or named like a lock)
            if isinstance(value, ast.Name):
                pname = value.id
                if pname in ann:
                    t = ann[pname]
                    if t in ("Lock", "RLock"):
                        ci.locks.setdefault(attr, LockDef(
                            id=f"{self.module}.{ci.name}.{attr}",
                            kind="unknown", module=self.module, cls=ci.name,
                            attr=attr, line=sub.lineno, reentrant=True))
                    else:
                        ci.attr_types.setdefault(attr, t)
                elif fn.name == "__init__" and pname in params \
                        and not _lockish(pname):
                    ci.param_attrs.setdefault(attr, pname)
                elif _lockish(pname) and attr not in ci.locks:
                    # untyped lock-ish parameter (the registry's shared
                    # lock idiom): a lock node, assumed reentrant so an
                    # unknowable kind never fabricates a PT800 self-cycle
                    ci.locks.setdefault(attr, LockDef(
                        id=f"{self.module}.{ci.name}.{attr}",
                        kind="unknown", module=self.module, cls=ci.name,
                        attr=attr, line=sub.lineno, reentrant=True))

    def _lock_expr(self, value, ci: Optional[_ClassInfo]):
        """Recognize a lock-constructing expression.

        Returns (kind, reentrant, literal_name_or_None, alias_of_or_None)
        or None.
        """
        if not isinstance(value, ast.Call):
            return None
        fname = _dotted(value.func)
        if not fname:
            return None
        tail = fname.split(".")[-1]
        head = fname.split(".")[0]
        is_threading = (head == "threading" or fname == tail)
        if tail == "Lock" and is_threading:
            return ("lock", False, None, None)
        if tail == "RLock" and is_threading:
            return ("rlock", True, None, None)
        if tail == "Event" and is_threading:
            return ("event", False, None, None)
        if tail == "Condition" and is_threading:
            alias = self._cond_alias(value, ci)
            return ("condition", True, None, alias)
        if tail in ("make_lock", "make_rlock", "make_condition"):
            literal = None
            if value.args and isinstance(value.args[0], ast.Constant) \
                    and isinstance(value.args[0].value, str):
                literal = value.args[0].value
            if tail == "make_lock":
                return ("lock", False, literal, None)
            if tail == "make_rlock":
                return ("rlock", True, literal, None)
            alias = self._cond_alias(value, ci, arg_idx=1)
            return ("condition", True, literal if alias is None else None,
                    alias)
        return None

    def _cond_alias(self, call: ast.Call, ci: Optional[_ClassInfo],
                    arg_idx: int = 0) -> Optional[str]:
        """Condition(lock) / make_condition(name, lock): underlying lock."""
        args = call.args[arg_idx:]
        if not args:
            return None
        a = args[0]
        if isinstance(a, ast.Attribute) and isinstance(a.value, ast.Name) \
                and a.value.id == "self" and ci and a.attr in ci.locks:
            return ci.locks[a.attr].node
        if isinstance(a, ast.Name) and a.id in self.module_locks:
            return self.module_locks[a.id].node
        return None


def _dotted(node) -> Optional[str]:
    """'a.b.c' for a Name/Attribute chain, else None."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _lockish(name: str) -> bool:
    """A parameter named like a lock: ``lock``, ``shared_lock``,
    ``rlock`` — a word of the name, so ``gemm_blocks`` is not one."""
    return any(w in ("lock", "rlock")
               for w in name.lower().strip("_").split("_"))


def _ann_class(node) -> Optional[str]:
    """Class name out of an annotation (unwraps Optional[X] / 'X')."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        name = node.value.strip()
        return name.split("[")[0].split(".")[-1] if name else None
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Subscript):
        base = _dotted(node.value) or ""
        if base.split(".")[-1] in ("Optional", "Union"):
            inner = node.slice
            if isinstance(inner, ast.Tuple):
                for el in inner.elts:
                    t = _ann_class(el)
                    if t and t != "None":
                        return t
                return None
            return _ann_class(inner)
        return None
    return None


def _elem_class(node) -> Optional[str]:
    """The element class of a collection annotation (``List[X]``,
    ``Sequence[X]``, ``Set[X]``, ``Tuple[X, ...]``, ``Iterable[X]``)."""
    if not isinstance(node, ast.Subscript):
        return None
    base = (_dotted(node.value) or "").split(".")[-1]
    if base not in ("List", "list", "Sequence", "Set", "set", "Tuple",
                    "tuple", "Iterable", "FrozenSet", "Deque", "deque"):
        return None
    inner = node.slice
    if isinstance(inner, ast.Tuple):
        inner = inner.elts[0] if inner.elts else None
    t = _ann_class(inner) if inner is not None else None
    return t if t and t[0].isupper() and t != "Any" else None


def _ctor_class(value) -> Optional[str]:
    """'Foo' for ``Foo(...)`` / ``mod.Foo(...)`` constructor calls."""
    if not isinstance(value, ast.Call):
        return None
    name = _dotted(value.func)
    if not name:
        return None
    cuda = _cuda_ctor(name)
    if cuda:
        return cuda[1]
    tail = name.split(".")[-1]
    if tail and tail[0].isupper():
        return tail
    return None


def _cuda_ctor(name: str):
    """(kind, pseudo class) for a ``torch.cuda.<ctor>`` dotted name."""
    parts = name.split(".")
    if len(parts) >= 2 and parts[-2] == "cuda":
        return _CUDA_CTORS.get(parts[-1])
    return None


def _has_timeout(call: ast.Call) -> bool:
    if call.args:
        return True
    return any(kw.arg in ("timeout", "block") for kw in call.keywords)


# --------------------------------------------------------------------------
# function-body walk
# --------------------------------------------------------------------------

class _Analyzer:
    def __init__(self):
        self.collectors: Dict[str, _ModuleCollector] = {}
        self.class_index: Dict[str, List[_ClassInfo]] = {}
        self.funcs: Dict[Tuple, _FuncInfo] = {}
        self.relpaths: Dict[str, str] = {}

    # -- loading ---------------------------------------------------------

    def load(self, path: str, module: str, relpath: str):
        with open(path, "r", encoding="utf-8") as f:
            src = f.read()
        tree = ast.parse(src, filename=relpath)
        col = _ModuleCollector(
            module, relpath, tree,
            is_package=os.path.basename(path) == "__init__.py")
        col.collect()
        self.collectors[module] = col
        self.relpaths[module] = relpath
        for ci in col.classes.values():
            self.class_index.setdefault(ci.name, []).append(ci)

    def type_ctor_params(self) -> None:
        """Type the attrs a constructor stores from an unannotated
        parameter: from the one class its in-package callers pass there
        (``Cls(arg)`` / ``Cls(name=arg)`` with ``arg`` a constructor call,
        an annotated parameter, a local assigned a constructor call or a
        typed ``self`` attr), then an ``x if x is not None else
        getattr(p, "a", ...)`` fallback from ``p``'s type. Run after every
        module is read, twice, so one typed attr can type the next."""
        for _ in range(2):
            passed: Dict[Tuple[str, str, str], Set[str]] = {}
            for col in self.collectors.values():
                self._caller_types(col, passed)
            for col in self.collectors.values():
                for ci in col.classes.values():
                    for attr, p in ci.param_attrs.items():
                        if attr in ci.attr_types:
                            continue
                        got = passed.get((ci.module, ci.name, p), set())
                        if len(got) == 1:
                            ci.attr_types[attr] = next(iter(got))
                    for attr, (p, a) in ci.attr_refs.items():
                        if attr in ci.attr_types:
                            continue
                        got = passed.get((ci.module, ci.name, p), set())
                        t = ci.init_ann.get(p) or (
                            next(iter(got)) if len(got) == 1 else None)
                        other = self.find_class(t, ci.module) if t else None
                        if other is not None and a in other.attr_types:
                            ci.attr_types[attr] = other.attr_types[a]

    def _caller_types(self, col, passed) -> None:
        """Record, for every constructor call in ``col``'s functions, the
        class of each argument that has one, by (module, class, param)."""
        def funcs():
            for node in col.tree.body:
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    yield None, node
                elif isinstance(node, ast.ClassDef):
                    ci = col.classes.get(node.name)
                    for stmt in node.body:
                        if isinstance(stmt, (ast.FunctionDef,
                                             ast.AsyncFunctionDef)):
                            yield ci, stmt
        for ci, fn in funcs():
            env: Dict[str, str] = {}
            for arg in list(fn.args.args) + list(fn.args.kwonlyargs):
                t = _ann_class(arg.annotation) \
                    if arg.annotation is not None else None
                if t:
                    env[arg.arg] = t
            for sub in ast.walk(fn):
                if isinstance(sub, ast.Assign) and len(sub.targets) == 1 \
                        and isinstance(sub.targets[0], ast.Name):
                    t = _ctor_class(sub.value)
                    if t:
                        env.setdefault(sub.targets[0].id, t)
            for sub in ast.walk(fn):
                if not isinstance(sub, ast.Call):
                    continue
                key = self._callee_key(col, ci, sub.func, {}, {})
                if not key or key[1] is None or key[2] != "__init__":
                    continue
                kcol = self.collectors.get(key[0])
                kci = kcol.classes.get(key[1]) if kcol else None
                if kci is None:
                    continue
                pairs = list(zip(kci.init_params, sub.args)) + [
                    (kw.arg, kw.value) for kw in sub.keywords if kw.arg]
                for p, arg in pairs:
                    t = _ctor_class(arg)
                    if t is None and isinstance(arg, ast.Name):
                        t = env.get(arg.id)
                    if t is None and isinstance(arg, ast.Attribute):
                        owner = self._class_of_expr(col, ci, arg.value, env)
                        t = owner.attr_types.get(arg.attr) \
                            if owner is not None else None
                    if t and self.find_class(t, col.module) is not None:
                        passed.setdefault((kci.module, kci.name, p),
                                          set()).add(t)

    def find_class(self, name: str, prefer_module: str) -> \
            Optional[_ClassInfo]:
        cands = self.class_index.get(name, [])
        if not cands:
            return None
        for ci in cands:
            if ci.module == prefer_module:
                return ci
        return cands[0] if len(cands) == 1 else None

    # -- walking ---------------------------------------------------------

    def walk_all(self):
        for module, col in self.collectors.items():
            for cname, ci in col.classes.items():
                node = None
                for stmt in col.tree.body:
                    if isinstance(stmt, ast.ClassDef) and stmt.name == cname:
                        node = stmt
                        break
                if node is None:
                    continue
                for stmt in node.body:
                    if isinstance(stmt, (ast.FunctionDef,
                                         ast.AsyncFunctionDef)):
                        self._walk_function(col, ci, stmt)
            for fname, fnode in col.module_funcs.items():
                self._walk_function(col, None, fnode)

    def _walk_function(self, col: _ModuleCollector,
                       ci: Optional[_ClassInfo], fn,
                       name_override: Optional[str] = None):
        key = (col.module, ci.name if ci else None,
               name_override or fn.name)
        info = _FuncInfo(key=key, site=f"{col.relpath}:{fn.lineno}")
        self.funcs[key] = info
        env: Dict[str, str] = {}    # local var -> class name
        kinds: Dict[str, str] = {}  # local var -> receiver kind
        for arg in list(fn.args.args) + list(fn.args.kwonlyargs):
            if arg.annotation is not None:
                t = _ann_class(arg.annotation)
                if t:
                    env[arg.arg] = t
        self._walk_body(col, ci, info, fn.body, (), env, kinds)

    # the core recursive walk; ``held`` is a tuple of lock node ids
    def _walk_body(self, col, ci, info, stmts, held, env, kinds):
        for stmt in stmts:
            self._walk_stmt(col, ci, info, stmt, held, env, kinds)

    def _walk_stmt(self, col, ci, info, stmt, held, env, kinds):
        site = f"{col.relpath}:{stmt.lineno}"
        if isinstance(stmt, ast.With):
            inner = held
            for item in stmt.items:
                node = self._lock_of(col, ci, item.context_expr, env)
                if node is not None:
                    info.acquires.append((inner, node, site))
                    inner = inner + (node,)
                else:
                    # not a lock: still scan the expression for calls
                    self._walk_expr(col, ci, info, item.context_expr,
                                    inner, env, kinds)
                    # a class-instance context manager runs __enter__ and
                    # __exit__ with everything acquired so far still held
                    # (RecordEvent's __exit__ takes the profiler lock)
                    cm = item.context_expr
                    ckey = self._callee_key(col, ci, cm.func, env, kinds) \
                        if isinstance(cm, ast.Call) else None
                    if ckey is None and not isinstance(cm, ast.Call):
                        ckey = self._callee_key(col, ci, cm, env, kinds)
                    cm_cls = None
                    if ckey and ckey[1] is not None \
                            and ckey[2] == "__init__":
                        cm_cls = (ckey[0], ckey[1])
                    elif ckey and ckey[1] is None:
                        # factory function: the return annotation names
                        # the context-manager class (trace.span -> Span)
                        fcol = self.collectors.get(ckey[0])
                        node = fcol.module_funcs.get(ckey[2]) \
                            if fcol else None
                        ret = _ann_class(getattr(node, "returns", None)) \
                            if node is not None else None
                        if ret:
                            cm_cls = (ckey[0], ret)
                    if cm_cls is not None:
                        ccol = self.collectors.get(cm_cls[0])
                        cci = ccol.classes.get(cm_cls[1]) if ccol else None
                        if cci is None:
                            cci = self.find_class(cm_cls[1], cm_cls[0])
                        if cci is not None:
                            for dunder in ("__enter__", "__exit__"):
                                mkey = self._method_in(cci, dunder)
                                if mkey:
                                    info.calls.append((inner, mkey, site))
            self._walk_body(col, ci, info, stmt.body, inner, env, kinds)
            return
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            # nested def: analyzed as its own pseudo-function so a
            # Thread(target=inner) entry point resolves to it
            nested_name = f"{info.key[2]}.<locals>.{stmt.name}"
            self._walk_function(col, ci, stmt, name_override=nested_name)
            env[stmt.name] = ""       # not a class instance
            kinds[stmt.name] = "localfunc:" + nested_name
            return
        if isinstance(stmt, ast.ClassDef):
            return  # nested helper class: out of model
        if isinstance(stmt, ast.Assign):
            self._track_assign(col, ci, stmt, env, kinds)
            for tgt in stmt.targets:
                self._record_attr_target(ci, info, tgt, held, site)
            self._walk_expr(col, ci, info, stmt.value, held, env, kinds)
            return
        if isinstance(stmt, ast.For) and isinstance(stmt.target, ast.Name):
            # for r in list(self.router.replicas): r is a Replica
            t = self._elem_of(col, ci, stmt.iter, env)
            if t:
                env[stmt.target.id] = t
        if isinstance(stmt, ast.AugAssign):
            self._record_attr_target(ci, info, stmt.target, held, site)
            # an augmented write also reads
            self._record_attr_read(ci, info, stmt.target, held, site)
            self._walk_expr(col, ci, info, stmt.value, held, env, kinds)
            return
        # generic: recurse into child statements with the same held set,
        # and scan expressions
        for field in ast.iter_child_nodes(stmt):
            if isinstance(field, ast.stmt):
                self._walk_stmt(col, ci, info, field, held, env, kinds)
            elif isinstance(field, ast.expr):
                self._walk_expr(col, ci, info, field, held, env, kinds)
            elif isinstance(field, (ast.excepthandler,)):
                self._walk_body(col, ci, info, field.body, held, env, kinds)

    def _walk_expr(self, col, ci, info, expr, held, env, kinds):
        for node in ast.walk(expr):
            if isinstance(node, ast.Call):
                self._record_call(col, ci, info, node, held, env, kinds)
            elif isinstance(node, ast.Attribute) \
                    and isinstance(node.ctx, ast.Load):
                self._record_attr_read(ci, info, node, held,
                                       f"{col.relpath}:{node.lineno}")

    # -- events ----------------------------------------------------------

    def _record_attr_target(self, ci, info, tgt, held, site):
        if isinstance(tgt, ast.Tuple):
            for el in tgt.elts:
                self._record_attr_target(ci, info, el, held, site)
            return
        if isinstance(tgt, ast.Subscript):
            # self.d[k] = v mutates self.d
            tgt = tgt.value
        if isinstance(tgt, ast.Attribute) and isinstance(tgt.value, ast.Name) \
                and tgt.value.id == "self" and ci is not None:
            info.attr_events.append((tgt.attr, True, bool(held), site))

    def _record_attr_read(self, ci, info, node, held, site):
        if isinstance(node, ast.Attribute) \
                and isinstance(node.value, ast.Name) \
                and node.value.id == "self" and ci is not None:
            info.attr_events.append((node.attr, False, bool(held), site))

    def _track_assign(self, col, ci, stmt, env, kinds):
        if len(stmt.targets) != 1 or not isinstance(stmt.targets[0],
                                                    ast.Name):
            return
        name = stmt.targets[0].id
        v = stmt.value
        if isinstance(v, ast.Call) and isinstance(v.func, ast.Attribute) \
                and v.func.attr == "setdefault" \
                and isinstance(v.func.value, ast.Name) \
                and f"{v.func.value.id}[]" in col.module_locks:
            # name_lock = _name_locks.setdefault(name, Lock()): the local
            # is the keyed lock ("@" marks a lock, never a class name)
            env[name] = f"@{v.func.value.id}[]"
            return
        t = _ctor_class(stmt.value)
        if t:
            env[name] = t
            k = self._ctor_kind(stmt.value)
            if k:
                kinds[name] = k
            return
        # plan = active_plan(): a resolvable call whose return annotation
        # names the class types the local — this is what lets
        # `plan.hit(site)` (fault_point) resolve to FaultPlan.hit and
        # predict the caller-held-lock -> FaultPlan._lock edge
        if isinstance(stmt.value, ast.Call):
            ckey = self._callee_key(col, ci, stmt.value.func, env, kinds)
            ret = self._return_class(ckey) if ckey else None
            if ret:
                env[name] = ret
                return
        # x = self.attr  (typed attr or property)
        if isinstance(stmt.value, ast.Attribute) \
                and isinstance(stmt.value.value, ast.Name) \
                and stmt.value.value.id == "self" and ci is not None:
            attr = stmt.value.attr
            if attr in ci.attr_types:
                env[name] = ci.attr_types[attr]
            elif attr in ci.prop_types:
                env[name] = ci.prop_types[attr]
            elif attr in ci.locks and ci.locks[attr].kind == "event":
                kinds[name] = "event"

    def _return_class(self, key: Tuple) -> Optional[str]:
        """Class named by the resolved callee's return annotation (the
        class itself for a ``__init__`` key)."""
        mod, cls, fname = key
        if cls is not None and fname == "__init__":
            return cls
        c = self.collectors.get(mod)
        if c is None:
            return None
        node = None
        if cls is None:
            node = c.module_funcs.get(fname)
        else:
            for stmt in c.tree.body:
                if isinstance(stmt, ast.ClassDef) and stmt.name == cls:
                    for s in stmt.body:
                        if isinstance(s, (ast.FunctionDef,
                                          ast.AsyncFunctionDef)) \
                                and s.name == fname:
                            node = s
                            break
                    break
        if node is None or getattr(node, "returns", None) is None:
            return None
        return _ann_class(node.returns)

    def _ctor_kind(self, call: ast.Call) -> Optional[str]:
        name = _dotted(call.func) or ""
        cuda = _cuda_ctor(name)
        if cuda:
            return cuda[0]
        tail = name.split(".")[-1]
        return {"Popen": "popen", "Thread": "thread", "Queue": "queue",
                "LifoQueue": "queue", "PriorityQueue": "queue",
                "socket": "socket", "HTTPConnection": "httpconn",
                "HTTPSConnection": "httpconn", "Event": "event",
                }.get(tail)

    # -- lock resolution -------------------------------------------------

    def _class_lock(self, ci: Optional[_ClassInfo],
                    attr: str) -> Optional[LockDef]:
        """Lock attribute lookup through the MRO approximation (subclass
        engines inherit ``_lock``/``_work`` from ServingEngine)."""
        seen: Set[str] = set()
        cur = ci
        while cur and cur.name not in seen:
            seen.add(cur.name)
            if attr in cur.locks:
                return cur.locks[attr]
            nxt = None
            for b in cur.bases:
                nxt = self.find_class(b, cur.module)
                if nxt:
                    break
            cur = nxt
        return None

    def _lock_of(self, col, ci, expr, env) -> Optional[str]:
        """Lock graph node acquired by ``with <expr>:`` (or None)."""
        d = self._lock_def_of(col, ci, expr, env)
        if d is not None and d.kind in _LOCK_KINDS + ("unknown",):
            return d.node
        return None

    def _lock_def_of(self, col, ci, expr, env) -> Optional[LockDef]:
        if isinstance(expr, ast.Attribute):
            base = expr.value
            if isinstance(base, ast.Name):
                if base.id == "self" and ci is not None:
                    return self._class_lock(ci, expr.attr)
                # local var with inferred class type
                t = env.get(base.id)
                if t:
                    other = self.find_class(t, col.module)
                    if other:
                        return self._class_lock(other, expr.attr)
                # imported module global: mod.LOCK
                if base.id in col.imports or base.id in col.symbols:
                    target = self._module_of_alias(col, base.id)
                    if target and target in self.collectors:
                        return self.collectors[target].module_locks.get(
                            expr.attr)
                return None
            if isinstance(base, ast.Attribute) \
                    and isinstance(base.value, ast.Name) \
                    and base.value.id == "self" and ci is not None:
                # self.attr.LOCK where attr type is known
                t = ci.attr_types.get(base.attr) \
                    or ci.prop_types.get(base.attr)
                if t:
                    other = self.find_class(t, col.module)
                    if other:
                        return self._class_lock(other, expr.attr)
            return None
        if isinstance(expr, ast.Name):
            if env.get(expr.id, "").startswith("@"):
                return col.module_locks.get(env[expr.id][1:])
            if expr.id in col.module_locks:
                return col.module_locks[expr.id]
            if expr.id in col.symbols:
                mod, sym = col.symbols[expr.id]
                if mod in self.collectors:
                    return self.collectors[mod].module_locks.get(sym)
        return None

    def _module_of_alias(self, col, alias: str) -> Optional[str]:
        if alias in col.symbols:
            mod, sym = col.symbols[alias]
            cand = f"{mod}.{sym}" if mod else sym
            if cand in self.collectors:
                return cand
            return mod if mod in self.collectors else None
        if alias in col.imports:
            return col.imports[alias]
        return None

    # -- call recording --------------------------------------------------

    def _record_call(self, col, ci, info, call: ast.Call, held, env, kinds):
        site = f"{col.relpath}:{call.lineno}"
        # thread entry points
        name = _dotted(call.func) or ""
        tail = name.split(".")[-1]
        if tail == "Thread":
            for kw in call.keywords:
                if kw.arg == "target":
                    tkey = self._callee_key(col, ci, kw.value, env, kinds)
                    if tkey:
                        info.thread_targets.append((tkey, site))
        # blocking?
        what = self._blocking_what(col, ci, call, env, kinds, held)
        if what:
            info.blocking.append((held, what, site))
        # call-graph edge
        ckey = self._callee_key(col, ci, call.func, env, kinds)
        if ckey:
            info.calls.append((held, ckey, site))
        # a function passed as a callable argument is conservatively
        # invoked by the callee with the caller's locks still held
        # (call_with_retry(_build) and call_with_retry("compile",
        # _faults.fault_point, "compile") run it synchronously): a local
        # function, or a module function named through an import; Thread
        # targets are excluded — a new thread starts with NO locks
        if tail != "Thread":
            for arg in list(call.args) + [kw.value for kw in call.keywords]:
                if isinstance(arg, ast.Name) \
                        and kinds.get(arg.id, "").startswith("localfunc:"):
                    nested = (col.module, ci.name if ci else None,
                              kinds[arg.id].split(":", 1)[1])
                    info.calls.append((held, nested, site))
                elif isinstance(arg, (ast.Name, ast.Attribute)):
                    fkey = self._callee_key(col, ci, arg, env, kinds)
                    if fkey is not None and fkey[1] is None:
                        info.calls.append((held, fkey, site))

    def _elem_of(self, col, ci, it, env) -> Optional[str]:
        """The element class of an iterated expression: an attr a class
        types as a collection (``self.x`` or ``<typed>.x``, through
        ``self.<typed attr>.x``), under ``list``/``tuple``/``sorted``."""
        while isinstance(it, ast.Call) and isinstance(it.func, ast.Name) \
                and it.func.id in ("list", "tuple", "sorted") and it.args:
            it = it.args[0]
        if not isinstance(it, ast.Attribute):
            return None
        owner = self._class_of_expr(col, ci, it.value, env)
        return owner.elem_types.get(it.attr) if owner is not None else None

    def _class_of_expr(self, col, ci, expr, env) -> Optional[_ClassInfo]:
        """The class of ``self``, a typed local or ``<one of those>.attr``."""
        if isinstance(expr, ast.Name):
            if expr.id == "self":
                return ci
            t = env.get(expr.id)
            return self.find_class(t, col.module) if t else None
        if isinstance(expr, ast.Attribute):
            owner = self._class_of_expr(col, ci, expr.value, env)
            if owner is None:
                return None
            t = owner.attr_types.get(expr.attr) \
                or owner.prop_types.get(expr.attr)
            return self.find_class(t, col.module) if t else None
        return None

    def _callee_key(self, col, ci, func, env, kinds) -> Optional[Tuple]:
        """(module, class, name) the call/reference resolves to, or None."""
        if isinstance(func, ast.Name):
            nm = func.id
            if kinds.get(nm, "").startswith("localfunc:"):
                return (col.module, ci.name if ci else None,
                        kinds[nm].split(":", 1)[1])
            if nm in col.module_funcs:
                return (col.module, None, nm)
            if nm in col.symbols:
                mod, sym = col.symbols[nm]
                if mod in self.collectors:
                    c = self.collectors[mod]
                    if sym in c.module_funcs:
                        return (mod, None, sym)
                    if sym in c.classes:
                        return (mod, sym, "__init__")
            if nm in col.classes:
                return (col.module, nm, "__init__")
            return None
        if not isinstance(func, ast.Attribute):
            return None
        meth = func.attr
        base = func.value
        if isinstance(base, ast.Name):
            if base.id == "self" and ci is not None:
                target = self._method_in(ci, meth)
                if target:
                    return target
                return None
            t = env.get(base.id) or col.module_instances.get(base.id)
            if not t and base.id in col.symbols:
                # imported module-level singleton
                mod, sym = col.symbols[base.id]
                c = self.collectors.get(mod)
                if c:
                    t = c.module_instances.get(sym)
            if t:
                other = self.find_class(t, col.module)
                if other:
                    return self._method_in(other, meth)
                return None
            target_mod = self._module_of_alias(col, base.id)
            if target_mod and target_mod in self.collectors:
                c = self.collectors[target_mod]
                if meth in c.module_funcs:
                    return (target_mod, None, meth)
                if meth in c.classes:
                    return (target_mod, meth, "__init__")
            return None
        if isinstance(base, ast.Attribute) and isinstance(base.value,
                                                          ast.Name):
            t = None
            if base.value.id == "self" and ci is not None:
                t = ci.attr_types.get(base.attr) \
                    or ci.prop_types.get(base.attr)
            else:
                # r.future._settle() where r's class is known (annotated
                # param / tracked local) and its class types the attr
                t0 = env.get(base.value.id)
                rcls = self.find_class(t0, col.module) if t0 else None
                if rcls is not None:
                    t = rcls.attr_types.get(base.attr) \
                        or rcls.prop_types.get(base.attr)
            if t:
                other = self.find_class(t, col.module)
                if other:
                    return self._method_in(other, meth)
        if isinstance(base, ast.Call):
            # get_tracker().observe(...): the accessor's return annotation
            # names the receiver class
            inner = self._callee_key(col, ci, base.func, env, kinds)
            if inner is not None:
                mod, cls, fname = inner
                if cls is not None and fname == "__init__":
                    # ClassName(...).method()
                    icol = self.collectors.get(mod)
                    icls = icol.classes.get(cls) if icol else None
                    if icls is not None:
                        return self._method_in(icls, meth)
                icol = self.collectors.get(mod)
                node = icol.module_funcs.get(fname) if icol and cls is None \
                    else None
                ret = _ann_class(node.returns) \
                    if node is not None and getattr(node, "returns", None) \
                    else None
                if ret:
                    other = self.find_class(ret, mod)
                    if other is not None:
                        return self._method_in(other, meth)
        return None

    def _method_in(self, ci: _ClassInfo, meth: str) -> Optional[Tuple]:
        seen = set()
        cur: Optional[_ClassInfo] = ci
        while cur and cur.name not in seen:
            seen.add(cur.name)
            key = (cur.module, cur.name, meth)
            if key in self.funcs or self._class_has_method(cur, meth):
                return key
            nxt = None
            for b in cur.bases:
                nxt = self.find_class(b, cur.module)
                if nxt:
                    break
            cur = nxt
        return None

    def _class_has_method(self, ci: _ClassInfo, meth: str) -> bool:
        col = self.collectors.get(ci.module)
        if not col:
            return False
        for stmt in col.tree.body:
            if isinstance(stmt, ast.ClassDef) and stmt.name == ci.name:
                return any(isinstance(s, (ast.FunctionDef,
                                          ast.AsyncFunctionDef))
                           and s.name == meth for s in stmt.body)
        return False

    # -- blocking detection ----------------------------------------------

    def _blocking_what(self, col, ci, call, env, kinds, held) -> \
            Optional[str]:
        name = _dotted(call.func)
        if name:
            resolved = self._resolve_func_name(col, name)
            if resolved in _BLOCKING_FUNCS:
                return _BLOCKING_FUNCS[resolved]
        if not isinstance(call.func, ast.Attribute):
            return None
        meth = call.func.attr
        if meth == "block_until_ready":
            return "block_until_ready"
        recv = call.func.value
        kind = self._receiver_kind(col, ci, recv, env, kinds)
        if kind == "event" and meth == "wait" and not _has_timeout(call):
            return "Event.wait (no timeout)"
        if kind == "condition" and meth == "wait":
            # Condition.wait releases its own lock; only waiting while
            # holding a *different* lock blocks other threads
            d = self._lock_def_of(col, ci, recv, env)
            own = {d.node} if d is not None else set()
            others = [h for h in held if h not in own]
            if others:
                return "Condition.wait holding another lock"
            return None
        if kind in _BLOCKING_METHODS and meth in _BLOCKING_METHODS[kind]:
            if meth in ("wait", "join", "get", "put", "communicate") \
                    and _has_timeout(call):
                return None
            if meth.endswith("_nowait"):
                return None
            return f"{kind}.{meth}"
        return None

    def _resolve_func_name(self, col, dotted_name: str) -> str:
        head, _, rest = dotted_name.partition(".")
        if head in col.imports:
            base = col.imports[head]
            return f"{base}.{rest}" if rest else base
        if head in col.symbols:
            mod, sym = col.symbols[head]
            full = f"{mod}.{sym}" if mod else sym
            return f"{full}.{rest}" if rest else full
        return dotted_name

    def _receiver_kind(self, col, ci, recv, env, kinds) -> Optional[str]:
        d = self._lock_def_of(col, ci, recv, env)
        if d is not None:
            return d.kind
        if isinstance(recv, ast.Name):
            return kinds.get(recv.id)
        if isinstance(recv, ast.Attribute) \
                and isinstance(recv.value, ast.Name) \
                and recv.value.id == "self" and ci is not None:
            t = ci.attr_types.get(recv.attr)
            return {"Popen": "popen", "Thread": "thread", "Queue": "queue",
                    "HTTPConnection": "httpconn", "Event": "event",
                    "CudaEvent": "cudaevent", "CudaStream": "cudastream",
                    }.get(t or "")
        if isinstance(recv, ast.Call):
            return self._ctor_kind(recv)
        return None


# --------------------------------------------------------------------------
# graph construction + diagnostics
# --------------------------------------------------------------------------

def _transitive_sets(analyzer: _Analyzer):
    """Fixed point of acquires*(f) and blocking*(f) over the call graph."""
    acquires: Dict[Tuple, Set[str]] = {}
    blocking: Dict[Tuple, Dict[str, str]] = {}   # what -> via path
    for key, fn in analyzer.funcs.items():
        acquires[key] = {node for _, node, _ in fn.acquires}
        blocking[key] = {what: fn.qualname for _, what, _ in fn.blocking}
    changed = True
    while changed:
        changed = False
        for key, fn in analyzer.funcs.items():
            for _, callee, _ in fn.calls:
                if callee not in acquires:
                    continue
                extra = acquires[callee] - acquires[key]
                if extra:
                    acquires[key] |= extra
                    changed = True
                for what, via in blocking[callee].items():
                    if what not in blocking[key]:
                        blocking[key][what] = via
                        changed = True
    return acquires, blocking


def _guard_sets(analyzer: _Analyzer) -> Dict[Tuple, Set[str]]:
    """Locks held at EVERY resolved call site of each function.

    The repo's ``_foo_locked`` helper idiom puts state access in methods
    whose body never names the lock — the caller holds it.  This is the
    meet-over-call-sites dataflow that recovers that: ``guard(f)`` is the
    intersection over all resolved calls to ``f`` of (locks lexically
    held at the site ∪ the caller's own guard).  Functions with no
    resolved caller (entry points, public API) have an empty guard.
    Optimistic (greatest-fixpoint) iteration, so mutually recursive
    helpers that are only ever entered under the lock keep it.
    """
    guard: Dict[Tuple, Optional[Set[str]]] = \
        {k: None for k in analyzer.funcs}        # None = unknown (top)
    callers: Dict[Tuple, List[Tuple[Tuple, Tuple[str, ...]]]] = {}
    for key, fn in analyzer.funcs.items():
        for held, callee, _ in fn.calls:
            if callee in guard:
                callers.setdefault(callee, []).append((key, held))
    changed = True
    while changed:
        changed = False
        for callee, sites in callers.items():
            inbound: Optional[Set[str]] = None
            for caller_key, held in sites:
                g = guard.get(caller_key)
                if g is None and callers.get(caller_key):
                    continue           # caller still unresolved: skip
                eff = set(held) | (g or set())
                inbound = set(eff) if inbound is None else (inbound & eff)
            if inbound is None:
                continue
            prev = guard[callee]
            if prev is not None:
                inbound &= prev        # enforce monotone descent
                if inbound == prev:
                    continue
            guard[callee] = inbound
            changed = True
    return {k: (v or set()) for k, v in guard.items()}


def _analyze(analyzer: _Analyzer) -> ConcurrencyReport:
    analyzer.walk_all()
    acquires, blocking = _transitive_sets(analyzer)
    guards = _guard_sets(analyzer)

    # lock inventory
    locks: Dict[str, LockDef] = {}
    for col in analyzer.collectors.values():
        for d in col.module_locks.values():
            locks.setdefault(d.id, d)
        for ci in col.classes.values():
            for d in ci.locks.values():
                locks.setdefault(d.id, d)
    reentrant_nodes = {d.node for d in locks.values()
                       if d.reentrant or d.kind == "unknown"}

    edges: List[LockEdge] = []
    edge_keys: Set[Tuple[str, str]] = set()
    diags: List[Diagnostic] = []
    diag_keys: Set[Tuple[str, str]] = set()

    def add_diag(code, key, message, site):
        if (code, key) in diag_keys:
            return
        diag_keys.add((code, key))
        diags.append(Diagnostic(code=code, message=message,
                                op_type=key, site=site))

    def add_edge(src, dst, site, via=""):
        if src == dst:
            if src not in reentrant_nodes:
                add_diag(
                    "PT800", src,
                    f"non-reentrant lock '{src}' re-acquired while already "
                    f"held{' via ' + via if via else ''} — guaranteed "
                    f"self-deadlock", site)
            return
        if (src, dst) not in edge_keys:
            edge_keys.add((src, dst))
            edges.append(LockEdge(src=src, dst=dst, site=site, via=via))

    for key, fn in analyzer.funcs.items():
        guard = guards.get(key, set())
        for held, node, site in fn.acquires:
            for h in set(held) | guard:
                add_edge(h, node, site)
        for held, callee, site in fn.calls:
            eff = set(held) | guard
            if not eff or callee not in acquires:
                continue
            callee_fn = analyzer.funcs.get(callee)
            via = callee_fn.qualname if callee_fn else ".".join(
                str(p) for p in callee if p)
            for node in acquires[callee]:
                for h in eff:
                    add_edge(h, node, site, via=via)
        # PT801: direct blocking under a held (or guard-implied) lock
        for held, what, site in fn.blocking:
            eff = set(held) | guard
            if eff:
                add_diag(
                    "PT801", f"{fn.qualname}+{what}",
                    f"{fn.qualname} calls {what} while holding "
                    f"{', '.join(sorted(eff))}", site)
        # PT801: blocking reached through a resolved call
        for held, callee, site in fn.calls:
            eff = set(held) | guard
            if not eff or callee not in blocking:
                continue
            for what, via in blocking[callee].items():
                add_diag(
                    "PT801", f"{fn.qualname}+{what}",
                    f"{fn.qualname} calls {via} (which reaches {what}) "
                    f"while holding {', '.join(sorted(eff))}", site)

    # PT800: cycles across the whole graph
    nodes = {d.node for d in locks.values()} \
        | {e.src for e in edges} | {e.dst for e in edges}
    for cycle in _find_cycles(nodes, edge_keys):
        key = "->".join(cycle)
        samples = [e for e in edges
                   if e.src in cycle and e.dst in cycle][:4]
        sites = "; ".join(f"{e.src}->{e.dst} at {e.site}" for e in samples)
        add_diag("PT800", key,
                 f"lock-order cycle between {', '.join(cycle)} ({sites})",
                 samples[0].site if samples else "")

    # PT802: unguarded cross-thread attributes
    _pt802(analyzer, guards, add_diag)

    return ConcurrencyReport(
        locks=locks, edges=edges, diagnostics=diags,
        modules=sorted(analyzer.collectors),
        functions=len(analyzer.funcs))


def _pt802(analyzer: _Analyzer, guards: Dict[Tuple, Set[str]], add_diag):
    # thread targets per class: (module, cls) -> {method name, ...}
    targets: Dict[Tuple[str, str], Set[str]] = {}
    for fn in analyzer.funcs.values():
        for tkey, _ in fn.thread_targets:
            mod, cls, name = tkey
            if cls is not None:
                targets.setdefault((mod, cls), set()).add(name)
    for (mod, cls), entry_names in sorted(targets.items()):
        col = analyzer.collectors.get(mod)
        ci = col.classes.get(cls) if col else None
        if ci is None:
            continue
        methods = {key[2]: fn for key, fn in analyzer.funcs.items()
                   if key[0] == mod and key[1] == cls}
        # transitive same-class closure of each thread entry point
        contexts: Dict[str, Set[str]] = {}
        for entry in entry_names:
            closure, frontier = set(), [entry]
            while frontier:
                m = frontier.pop()
                if m in closure or m not in methods:
                    continue
                closure.add(m)
                for _, callee, _ in methods[m].calls:
                    if callee[0] == mod and callee[1] == cls:
                        frontier.append(callee[2])
            contexts[entry] = closure
        thread_methods = set().union(*contexts.values()) if contexts else set()
        # attr -> events tagged with context label
        by_attr: Dict[str, List[Tuple[str, bool, bool, str]]] = {}
        for mname, fn in methods.items():
            if mname == "__init__" or mname.startswith("__init__.<locals>"):
                continue   # construction happens-before thread start
            labels = [e for e, cl in contexts.items() if mname in cl]
            label = labels[0] if labels else (
                "caller" if mname not in thread_methods else mname)
            guarded_fn = bool(guards.get((mod, cls, mname)))
            for attr, write, locked, site in fn.attr_events:
                by_attr.setdefault(attr, []).append(
                    (label, write, locked or guarded_fn, site))
        for attr, events in sorted(by_attr.items()):
            # locks/conditions/events (incl. inherited) are thread-safe
            if analyzer._class_lock(ci, attr) is not None \
                    or ci.attr_types.get(attr) == "Thread":
                continue
            ctxs = {label for label, _, _, _ in events}
            if len(ctxs) < 2:
                continue
            writes = [e for e in events if e[1]]
            unguarded = [e for e in events if not e[2]]
            if not writes or not unguarded:
                continue
            add_diag(
                "PT802", f"{cls}.{attr}",
                f"{cls}.{attr} is accessed from thread entry points "
                f"{sorted(c for c in ctxs if c != 'caller')} and "
                f"{'the caller side' if 'caller' in ctxs else 'nothing else'}"
                f" with {len(writes)} write(s) and {len(unguarded)} "
                f"unguarded access(es), e.g. {unguarded[0][3]}",
                unguarded[0][3])


# --------------------------------------------------------------------------
# public API
# --------------------------------------------------------------------------

def package_source_files(root: Optional[str] = None) -> List[str]:
    """Every .py file under the ``paddle_tpu_torch`` package directory."""
    if root is None:
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = []
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        for f in sorted(filenames):
            if f.endswith(".py"):
                out.append(os.path.join(dirpath, f))
    return sorted(out)


def _module_name(path: str, root: Optional[str]) -> Tuple[str, str]:
    """(dotted module name, display relpath) for one source file."""
    apath = os.path.abspath(path)
    if root:
        aroot = os.path.abspath(root)
        if apath.startswith(aroot + os.sep):
            rel = os.path.relpath(apath, os.path.dirname(aroot))
            mod = rel[:-3].replace(os.sep, ".")
            if mod.endswith(".__init__"):
                mod = mod[:-len(".__init__")]
            return mod, rel
    base = os.path.basename(apath)[:-3]
    return base, os.path.basename(apath)


def analyze_paths(paths: Sequence[str],
                  root: Optional[str] = None) -> ConcurrencyReport:
    """Analyze an explicit set of .py files (fixtures, subsets)."""
    analyzer = _Analyzer()
    for p in paths:
        mod, rel = _module_name(p, root)
        analyzer.load(p, mod, rel)
    analyzer.type_ctor_params()
    return _analyze(analyzer)


def analyze_package(root: Optional[str] = None) -> ConcurrencyReport:
    """Analyze the whole ``paddle_tpu_torch`` package (the CI gate
    input)."""
    if root is None:
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return analyze_paths(package_source_files(root), root=root)


def static_edge_set(report: Optional[ConcurrencyReport] = None) -> \
        Set[Tuple[str, str]]:
    """The static lock-order edge set the runtime witness gates against."""
    if report is None:
        report = analyze_package()
    return report.edge_set()
