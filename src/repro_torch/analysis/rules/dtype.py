"""Rule ``f32-cast``: dtype exactness for key tensors (counterpart of
``repro.analysis.rules.dtype``, with torch's spellings).

The index's correctness story depends on keys staying f64 until the
``f32_exact`` gate proves the f32 roundtrip lossless; an f32 cast of a
key-like tensor anywhere else silently merges f32-colliding keys.
Flagged spellings, where ``X`` mentions a key-like identifier
(``Config.key_name_re``): the reference's ``X.astype(np.float32 |
"float32")``, ``np.float32(X)`` and ``np.asarray/array(X,
dtype=float32)``, and torch's ``X.to(torch.float32)`` (the dtype
positional or ``dtype=``), ``X.float()`` and ``torch.tensor /
as_tensor(X, dtype=torch.float32)``.  Exempt contexts: modules under
``Config.f32_cast_ok_modules`` (the kernel boundary -- every wrapper sits
behind the gate) and functions that themselves implement or consult an
f32-exactness guard (their body references ``f32_exact`` /
``_delta_f32`` / ``_keys_f32_exact``, or the port's gate
``_use_kernel``).
"""
from __future__ import annotations

import ast
import re

from ..engine import finding
from .common import Rule, dotted

_F32_NAMES = {"float32", "f32", "_F32", "F32"}
_GUARD_RE = re.compile(
    r"\b(_?f32_exact|_delta_f32|_keys_f32_exact|_use_kernel)\b")


def _is_f32_dtype(node) -> bool:
    name = dotted(node)
    if name and name.split(".")[-1] in _F32_NAMES:
        return True
    return isinstance(node, ast.Constant) and node.value == "float32"


def _mentions_key(node, key_re) -> bool:
    for sub in ast.walk(node):
        if isinstance(sub, ast.Name) and key_re.search(sub.id):
            return True
        if isinstance(sub, ast.Attribute) and key_re.search(sub.attr):
            return True
    return False


def _guarded(fn_src: str) -> bool:
    return bool(_GUARD_RE.search(fn_src))


def _guard_map(tree) -> dict:
    """id(node) -> True when the node sits inside a def whose body
    references an f32-exactness guard."""
    guards: dict[int, bool] = {}

    def mark(node, guarded):
        for child in ast.iter_child_nodes(node):
            g = guarded
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                g = guarded or _guarded(ast.unparse(child))
            guards[id(child)] = g
            mark(child, g)

    mark(tree, False)
    return guards


def _cast_target(node, key_re):
    """The key-like value an f32 cast call converts, or None."""
    fn = node.func
    name = dotted(fn)
    if isinstance(fn, ast.Attribute) and fn.attr == "astype" \
            and node.args and _is_f32_dtype(node.args[0]) \
            and not isinstance(fn.value, ast.Compare) \
            and _mentions_key(fn.value, key_re):
        # (a Compare receiver is a boolean mask, not keys)
        return fn.value
    if isinstance(fn, ast.Attribute) and fn.attr == "to" \
            and (any(_is_f32_dtype(a) for a in node.args[:2])
                 or any(kw.arg == "dtype" and _is_f32_dtype(kw.value)
                        for kw in node.keywords)) \
            and not isinstance(fn.value, ast.Compare) \
            and _mentions_key(fn.value, key_re):
        return fn.value
    if isinstance(fn, ast.Attribute) and fn.attr == "float" \
            and not node.args and not isinstance(fn.value, ast.Compare) \
            and _mentions_key(fn.value, key_re):
        return fn.value
    if name and name.split(".")[-1] == "float32" and node.args \
            and _mentions_key(node.args[0], key_re):
        return node.args[0]
    if name and name.split(".")[-1] in {"asarray", "array", "tensor",
                                        "as_tensor"} \
            and node.args and _mentions_key(node.args[0], key_re):
        for kw in node.keywords:
            if kw.arg == "dtype" and _is_f32_dtype(kw.value):
                return node.args[0]
    return None


def check(project):
    key_re = re.compile(project.config.key_name_re)
    ok_prefixes = project.config.f32_cast_ok_modules
    for f in project.files:
        if f.module.startswith("repro_torch.analysis"):
            continue
        if any(f.module == p or f.module.startswith(p + ".")
               for p in ok_prefixes):
            continue
        # map each node to its innermost def's guardedness
        guards = _guard_map(f.tree)
        for node in ast.walk(f.tree):
            if not isinstance(node, ast.Call):
                continue
            hit = _cast_target(node, key_re)
            if hit is None or guards.get(id(node), False):
                continue
            yield finding(
                "f32-cast", f, node,
                f"f32 cast of key-like value {ast.unparse(hit)!r} outside "
                f"the f32_exact guard/kernel boundary — f32-colliding f64 "
                f"keys would silently merge")


RULE = Rule(
    id="f32-cast",
    doc="f32 cast of key tensors outside approved f32_exact guard sites",
    check=check,
)
