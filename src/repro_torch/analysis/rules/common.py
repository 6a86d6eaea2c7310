"""Shared rule plumbing: the Rule record and small AST utilities
(counterpart of ``repro.analysis.rules.common``, with torch's metadata
spellings)."""
from __future__ import annotations

import ast
from dataclasses import dataclass


@dataclass(frozen=True)
class Rule:
    id: str
    doc: str
    check: object               # callable(project) -> iterable[Finding]


def dotted(node: ast.AST) -> str | None:
    """``torch.cuda.synchronize``-style dotted name for Name/Attribute
    chains."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def own_body_nodes(func: ast.AST):
    """Walk a def's subtree, excluding nested def subtrees (those are
    separate call-graph nodes and would double-report)."""
    stack = list(ast.iter_child_nodes(func))
    while stack:
        node = stack.pop()
        yield node
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            stack.extend(ast.iter_child_nodes(node))


# Tensor and array metadata: reading it never waits for the device.
_META_ATTRS = {"shape", "ndim", "size", "dtype", "itemsize", "nbytes",
               "device", "is_cuda", "type", "layout"}
_META_METHODS = {"numel", "dim", "size", "element_size", "stride",
                 "is_contiguous", "data_ptr", "nelement", "ndimension",
                 "get_device"}
_META_FUNCS = {"len", "min", "max", "abs", "round", "sorted", "sum",
               "range", "int", "float", "bool", "str"}
_META_TORCH = {"torch.device", "torch.finfo", "torch.iinfo", "torch.Size"}
_HOST_REDUCTIONS = {"max", "min", "sum", "any", "all", "mean", "item",
                    "tolist", "astype", "copy", "bit_length", "argmax",
                    "argmin", "nonzero"}
_SCALAR_ANNOTATIONS = {"int", "float", "bool", "str"}


def scalar_env(fn: ast.AST) -> dict:
    """Host-value environment for :func:`is_metadata_expr`: parameters
    annotated with a scalar type map to True; every other name maps to
    the list of expressions assigned to it in the body (a name is then
    host-valued iff *all* of them are)."""
    env: dict = {}
    args = fn.args
    for a in args.posonlyargs + args.args + args.kwonlyargs:
        if isinstance(a.annotation, ast.Name) \
                and a.annotation.id in _SCALAR_ANNOTATIONS:
            env[a.arg] = True
    assigns: dict[str, list] = {}
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign):
            for t in node.targets:
                for name in ast.walk(t):
                    if isinstance(name, ast.Name):
                        assigns.setdefault(name.id, []).append(node.value)
        elif isinstance(node, ast.AugAssign) \
                and isinstance(node.target, ast.Name):
            assigns.setdefault(node.target.id, []).append(node.value)
        elif isinstance(node, ast.For):
            for name in ast.walk(node.target):
                if isinstance(name, ast.Name):
                    assigns.setdefault(name.id, []).append(node.iter)
    for name, exprs in assigns.items():
        env.setdefault(name, exprs)
    return env


def is_metadata_expr(node: ast.AST, env: dict | None = None,
                     _stack: frozenset = frozenset()) -> bool:
    """True when evaluating ``node`` can never force a device->host sync:
    python constants, scalar-annotated parameters, ``len()``/``math.*``
    arithmetic, ``.shape``/``.dtype``/``.device`` metadata and
    ``.numel()``/``.dim()``/``.size()``, host numpy results (``np.*``
    values already live on host -- the *call* that made them is judged
    separately), and reductions/arithmetic over any of those.  A bare
    untracked Name is *not* metadata -- it may hold a device tensor.
    Self-referential assignments resolve optimistically."""
    env = env or {}

    def rec(n, stack=_stack):
        return is_metadata_expr(n, env, stack)

    if isinstance(node, ast.Constant):
        return True
    if isinstance(node, ast.Name):
        if node.id in _stack:
            return True
        got = env.get(node.id)
        if got is True:
            return True
        if isinstance(got, list):
            stack = _stack | {node.id}
            return all(rec(e, stack) for e in got)
        return False
    if isinstance(node, ast.Attribute):
        return node.attr in _META_ATTRS or rec(node.value)
    if isinstance(node, ast.Subscript):
        return rec(node.value)
    if isinstance(node, ast.Call):
        fn = node.func
        if isinstance(fn, ast.Name) and fn.id in _META_FUNCS:
            return all(rec(a) for a in node.args)
        name = dotted(fn)
        if name and name.split(".")[0] == "math":
            return all(rec(a) for a in node.args)
        if name and name.split(".")[0] in {"np", "numpy"}:
            return True
        if name in _META_TORCH:
            return True
        if isinstance(fn, ast.Attribute) and fn.attr in _META_METHODS:
            return True
        if isinstance(fn, ast.Attribute) and fn.attr in _HOST_REDUCTIONS:
            return rec(fn.value)
        return False
    if isinstance(node, ast.BinOp):
        return rec(node.left) and rec(node.right)
    if isinstance(node, (ast.UnaryOp, ast.Starred)):
        return rec(node.operand if isinstance(node, ast.UnaryOp)
                   else node.value)
    if isinstance(node, ast.BoolOp):
        return all(rec(v) for v in node.values)
    if isinstance(node, ast.Compare):
        # a comparison with a string is a python bool (no tensor compares
        # with one)
        if any(isinstance(c, ast.Constant) and isinstance(c.value, str)
               for c in (node.left, *node.comparators)):
            return True
        return rec(node.left) and all(rec(c) for c in node.comparators)
    if isinstance(node, ast.IfExp):
        return rec(node.test) and rec(node.body) and rec(node.orelse)
    if isinstance(node, (ast.Tuple, ast.List)):
        return all(rec(e) for e in node.elts)
    return False
