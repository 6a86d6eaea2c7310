"""Rule ``retrace``: compiled objects rebuilt on every call (the port's
counterpart of ``repro.analysis.rules.retrace``).

The port traces nothing: no ``jax.jit``, so none of the reference's
traced-body checks (branches and coercions on traced values) apply.  The
hazard the reference guards against -- a compiled object built afresh on
every call, whose cache is therefore always cold -- becomes in torch a
call of ``torch.compile(...)``, ``torch.jit.script`` / ``trace``,
``torch.cuda.CUDAGraph()`` / ``torch.cuda.graph(...)`` (a graph capture)
or ``ctypes.CDLL(...)`` (a kernel library load).  Flagged:

* such a call on a lambda (``torch.compile(lambda ...)``): a fresh object
  a call-site evaluation;
* such a call inside a loop or comprehension, or anywhere in a def, unless
  the def is memoized -- by ``functools.lru_cache`` / ``cache``, or by the
  module-level dict-cache idiom (``kernels/build.py``'s ``_LIBS``: the def
  stores into a dict bound at module level, keyed by what it builds).

A module-level call outside a loop runs once at import and is clean.
"""
from __future__ import annotations

import ast

from ..engine import finding
from .common import Rule, dotted

_CONSTRUCTORS = {"torch.compile", "torch.jit.script", "torch.jit.trace",
                 "torch.cuda.CUDAGraph", "torch.cuda.graph", "ctypes.CDLL",
                 "CDLL", "ctypes.cdll.LoadLibrary"}
_MEMO_NAMES = {"functools.lru_cache", "lru_cache", "functools.cache",
               "cache"}
_LOOPS = (ast.For, ast.AsyncFor, ast.While, ast.ListComp, ast.SetComp,
          ast.DictComp, ast.GeneratorExp)
_DEFS = (ast.FunctionDef, ast.AsyncFunctionDef)


def _module_dicts(tree) -> set:
    """Names bound to a dict at module level (``_LIBS: dict = {}``)."""
    out = set()
    for node in tree.body:
        value = getattr(node, "value", None)
        if not (isinstance(value, ast.Dict) or isinstance(value, ast.Call)
                and dotted(value.func) == "dict"):
            continue
        if isinstance(node, ast.Assign):
            out.update(t.id for t in node.targets if isinstance(t, ast.Name))
        elif isinstance(node, ast.AnnAssign) \
                and isinstance(node.target, ast.Name):
            out.add(node.target.id)
    return out


def _memoized(fn, caches: set) -> bool:
    for dec in fn.decorator_list:
        target = dec.func if isinstance(dec, ast.Call) else dec
        if dotted(target) in _MEMO_NAMES:
            return True
    for node in ast.walk(fn):
        targets = node.targets if isinstance(node, ast.Assign) else []
        for t in targets:
            if isinstance(t, ast.Subscript) and isinstance(t.value, ast.Name) \
                    and t.value.id in caches:
                return True
        if isinstance(node, ast.Call) \
                and isinstance(node.func, ast.Attribute) \
                and node.func.attr == "setdefault" \
                and isinstance(node.func.value, ast.Name) \
                and node.func.value.id in caches:
            return True
    return False


def _scan(file):
    caches = _module_dicts(file.tree)

    def walk(node, in_loop, in_def, in_memo):
        for child in ast.iter_child_nodes(node):
            c_def, c_memo = in_def, in_memo
            c_loop = in_loop or isinstance(child, _LOOPS)
            if isinstance(child, _DEFS):
                c_def, c_loop = True, False
                c_memo = in_memo or _memoized(child, caches)
            if isinstance(child, ast.Call) \
                    and dotted(child.func) in _CONSTRUCTORS:
                name = dotted(child.func)
                if child.args and isinstance(child.args[0], ast.Lambda):
                    yield child, f"{name}(lambda ...) builds a fresh " \
                        f"object each time the call site runs"
                elif c_loop and not c_memo:
                    yield child, f"{name}(...) inside a loop builds a " \
                        f"fresh object every iteration (hoist it, or " \
                        f"memoize the factory)"
                elif c_def and not c_memo:
                    yield child, f"{name}(...) in a def that is not " \
                        f"memoized builds a fresh object every call " \
                        f"(functools.lru_cache, or a module-level dict " \
                        f"cache)"
            yield from walk(child, c_loop, c_def, c_memo)

    yield from walk(file.tree, False, False, False)


def check(project):
    for f in project.files:
        if f.module.startswith("repro_torch.analysis"):
            continue
        for node, msg in _scan(f):
            yield finding("retrace", f, node, msg)


RULE = Rule(
    id="retrace",
    doc="compiled objects rebuilt per call: torch.compile/jit/CUDA graph/"
        "ctypes.CDLL on a lambda, in a loop or outside a memoized def",
    check=check,
)
