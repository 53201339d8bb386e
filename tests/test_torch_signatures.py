"""The port's public parameters against the JAX package's.

``tools/print_signatures.py``'s ``walk`` lists every public callable of
both packages. For each name both lists hold, the port's callable must
accept the JAX one's parameters: every parameter name (or a ``**kwargs``
that takes it), the JAX one's positional parameters in the same order,
and each public method the JAX class defines. ``ALLOWED`` holds the
exceptions, each with the reason it stays, in the way
``test_torch_surface.STILL_MISSING`` does; an entry the check no longer
needs fails the test, so the list only shrinks. The JAX package's own
freeze (``tools/api_signatures.txt``, ``test_api_freeze``) is untouched.
"""
import importlib
import inspect
import os
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))
from print_signatures import walk  # noqa: E402

JAX_TYPES = "a jax type: the port has no counterpart of jax's own API"
LOWER_CTX = ("the op rules' context: the JAX one carries a jax PRNG key "
             "and an axis environment for its traced lowering; the "
             "port's carries a seed, the device and the mesh")

# "<owner>.<member>" as the JAX package defines it -> why the port differs
ALLOWED = {
    "OpDef.output_spec": "builds a jax ShapeDtypeStruct; the port's "
                         "registry infers shapes on meta tensors",
    "SelectedRows.tree_flatten": "jax pytree protocol",
    "SelectedRows.tree_unflatten": "jax pytree protocol",
    "CPUPlace.jax_device": "names a jax device; the port's place has "
                           "torch_device",
    "LowerCtx.__init__": LOWER_CTX,
    "LowerCtx.rng": LOWER_CTX,
    "Mesh.__init__": JAX_TYPES + " (jax.sharding.Mesh over devices; the "
                                 "port's Mesh is over launched ranks)",
    "Mesh.update": JAX_TYPES,
    "shard_axis_of": "the JAX one reads a live jax sharding off an array; "
                     "the port's layout lives on the scope "
                     "(scope, name, axis)",
}


def _resolve(qual):
    parts = qual.split(".")
    obj = importlib.import_module(parts[0])
    for p in parts[1:]:
        obj = getattr(obj, p)
    return obj


def _problem(jf, tf):
    """What ``tf`` does not accept of ``jf``'s parameters (None: all)."""
    try:
        js, ts = inspect.signature(jf), inspect.signature(tf)
    except (TypeError, ValueError):
        return None
    tp = ts.parameters
    var_kw = any(p.kind == p.VAR_KEYWORD for p in tp.values())
    var_pos = any(p.kind == p.VAR_POSITIONAL for p in tp.values())
    positional = (inspect.Parameter.POSITIONAL_ONLY,
                  inspect.Parameter.POSITIONAL_OR_KEYWORD)
    miss = []
    for p in js.parameters.values():
        if p.kind == p.VAR_KEYWORD:
            if not var_kw:
                miss.append("**" + p.name)
        elif p.kind == p.VAR_POSITIONAL:
            if not var_pos:
                miss.append("*" + p.name)
        elif p.name not in tp and not var_kw:
            miss.append(p.name)
    jpos = [p.name for p in js.parameters.values() if p.kind in positional]
    tpos = [p.name for p in tp.values() if p.kind in positional]
    if not miss and not var_pos and tpos[:len(jpos)] != jpos:
        miss.append(f"positional order {jpos} against {tpos}")
    return miss or None


def _owner_key(fn, name):
    owner = getattr(fn, "__qualname__", name).split(".")
    return ".".join(owner[-2:]) if len(owner) > 1 else owner[0]


def _pairs():
    """(key, JAX callable, port callable), once per pair of objects."""
    jax_names = walk("paddle_tpu")
    port_names = walk("paddle_tpu_torch")
    seen = set()
    for qual in sorted(jax_names):
        rest = qual[len("paddle_tpu."):]
        if "paddle_tpu_torch." + rest not in port_names:
            continue
        jf, tf = _resolve(qual), _resolve("paddle_tpu_torch." + rest)
        if (id(jf), id(tf)) in seen:
            continue
        seen.add((id(jf), id(tf)))
        if not (inspect.isclass(jf) and inspect.isclass(tf)):
            yield _owner_key(jf, rest.split(".")[-1]), jf, tf
            continue
        yield f"{jf.__name__}.__init__", jf.__init__, tf.__init__
        for mname, raw in vars(jf).items():
            if mname.startswith("_") or not (
                    inspect.isfunction(raw)
                    or isinstance(raw, (staticmethod, classmethod))):
                continue
            yield (f"{jf.__name__}.{mname}", getattr(jf, mname),
                   getattr(tf, mname, None))


def _findings():
    out = {}
    for key, jf, tf in _pairs():
        if tf is None:
            out.setdefault(key, "missing in the port")
            continue
        miss = _problem(jf, tf)
        if miss:
            out.setdefault(key, f"does not accept {miss}")
    return out


def _fresh_findings():
    """``_findings`` in a fresh interpreter: ``walk`` follows the
    submodules imported so far, so a process that other tests have
    filled would see another surface than the tool sees."""
    import json
    import subprocess

    code = ("import json, sys; sys.path.insert(0, 'tests'); "
            "import test_torch_signatures as t; "
            "print(json.dumps(t._findings()))")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def findings():
    return _fresh_findings()


def test_port_accepts_the_jax_parameters(findings):
    bad = {k: v for k, v in findings.items() if k not in ALLOWED}
    assert not bad, "\n".join(f"{k}: {v}" for k, v in sorted(bad.items()))


def test_every_allowed_exception_is_still_needed(findings):
    stale = sorted(set(ALLOWED) - set(findings))
    assert not stale, f"ALLOWED entries the check no longer needs: {stale}"


def test_every_allowed_exception_gives_a_reason():
    assert all(isinstance(v, str) and len(v) > 10 for v in ALLOWED.values())


@pytest.mark.parametrize("key, expected", [
    ("Executor.run", "use_program_cache"),
    ("append_backward", "checkpoints"),
    ("Optimizer.backward", "callbacks"),
    ("data", "type"),
    ("Variable.__init__", "initializer"),
    ("Scope.__init__", "parent"),
])
def test_the_check_sees_a_removed_parameter(key, expected):
    """Negative control: drop one parameter from the port's signature and
    the check names it."""
    for k, jf, tf in _pairs():
        if k != key:
            continue
        sig = inspect.signature(tf)
        cut = sig.replace(parameters=[p for p in sig.parameters.values()
                                      if p.name != expected])

        def stub(*a, **kw):
            pass
        stub.__signature__ = cut
        miss = _problem(jf, stub)
        assert miss and any(expected in m for m in miss), miss
        return
    pytest.fail(f"{key} not among the shared callables")
