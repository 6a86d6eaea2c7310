"""Rule ``hot-sync``: host synchronization in the serving hot path
(counterpart of ``repro.analysis.rules.hostsync``, in torch's spellings).

The hot path is the call-graph closure of ``Config.hot_roots`` (the
front-end's dispatch/resolve roots and the single index's serve verbs).
Within it, any construct that makes the host wait for the device is
flagged:

* a device-to-host read: ``.item()``, ``.tolist()``, ``.cpu()``,
  ``.numpy()``, ``.to("cpu" | torch.device("cpu"))``, and ``int()`` /
  ``float()`` / ``bool()`` of a non-metadata expression;
* a stream drain: ``torch.cuda.synchronize()``, ``.synchronize()`` of an
  event or stream;
* an op whose output size is data-dependent: ``torch.nonzero`` /
  ``.nonzero()`` (``nonzero_static`` reads nothing), ``torch.unique`` /
  ``unique_consecutive``, ``torch.masked_select``, ``torch.bincount``,
  ``torch.repeat_interleave`` without ``output_size``, a tensor indexed
  by a boolean mask, and the comparisons that answer a Python bool
  (``torch.equal``, ``torch.allclose``, ``torch.is_nonzero``);
* a host-to-device copy from pageable memory, which PyTorch makes
  synchronously: ``torch.tensor`` / ``as_tensor`` / ``asarray`` with a
  ``device``, ``.to(<device>)``, ``.cuda()``, ``.copy_()``;
* numpy materialization (``np.asarray`` / ``np.array`` / ``np.copy`` /
  ``np.ascontiguousarray``) of a value, and numpy's own data-dependent
  ``np.flatnonzero`` / ``np.nonzero`` / ``np.unique``;
* the truth of a tensor (``if x.any():``, ``x.all()`` in a test).

The static answer over-approximates: a ``.to(device)`` of a tensor that
is already there copies nothing, and numpy mirrors never touch the card.
The port reads on purpose at a few counted sites; each carries
``# tracelint: ok[hot-sync](reason)``, so the suppressed findings are the
map of its host reads (``chip_smoke.py`` holds the map against the syncs
the CUDA runtime reports).
"""
from __future__ import annotations

import ast

from ..engine import finding
from .common import (Rule, dotted, is_metadata_expr, own_body_nodes,
                     scalar_env)

_READ_METHODS = {"item", "tolist", "cpu", "numpy"}
_DRAIN_METHODS = {"synchronize"}
_SIZE_METHODS = {"nonzero", "unique", "unique_consecutive", "masked_select",
                 "bincount"}
_H2D_METHODS = {"cuda", "copy_"}
_TORCH_SYNC = {"torch.cuda.synchronize", "torch.nonzero", "torch.unique",
               "torch.unique_consecutive", "torch.masked_select",
               "torch.bincount", "torch.equal", "torch.allclose",
               "torch.is_nonzero"}
_TENSOR_CTORS = {"torch.tensor", "torch.as_tensor", "torch.asarray"}
_NUMPY_FUNCS = {"asarray", "array", "copy", "ascontiguousarray",
                "flatnonzero", "nonzero", "unique"}
_COERCIONS = {"int", "float", "bool"}
_DTYPES = {"float64", "float32", "float16", "bfloat16", "int64", "int32",
           "int16", "int8", "uint8", "bool", "long", "int", "float",
           "double", "half", "short", "complex64", "complex128"}
_MASK_FUNCS = {"isnan", "isinf", "isfinite", "isin", "isneginf",
               "isposinf", "logical_and", "logical_or", "logical_not",
               "logical_xor", "eq", "ne", "lt", "le", "gt", "ge"}


def _numpy_aliases(idx) -> set:
    out = set()
    for alias, mod in idx.mod_alias.items():
        if mod == "numpy" or mod.startswith("numpy."):
            out.add(alias)
    return out


def _dtype_names(nodes) -> set:
    """Names bound to a torch dtype among the assignments ``nodes``
    (``_F64 = torch.float64``, ``f64, f32 = torch.float64,
    torch.float32``)."""
    out = set()
    for node in nodes:
        if not isinstance(node, ast.Assign):
            continue
        for t in node.targets:
            pairs = zip(t.elts, node.value.elts) \
                if isinstance(t, ast.Tuple) and isinstance(
                    node.value, ast.Tuple) \
                and len(t.elts) == len(node.value.elts) \
                else [(t, node.value)]
            out.update(n.id for n, v in pairs
                       if isinstance(n, ast.Name) and _is_dtype(v, set()))
    return out


def _is_dtype(node, dtype_names) -> bool:
    name = dotted(node)
    if name is None:
        return False
    return name in dtype_names or name == "dtype" \
        or (name.startswith("torch.") and name.split(".")[-1] in _DTYPES) \
        or name.endswith(".dtype")


def _is_cpu(node) -> bool:
    if isinstance(node, ast.Constant):
        return node.value == "cpu"
    if isinstance(node, ast.Call) and dotted(node.func) == "torch.device":
        return bool(node.args) and _is_cpu(node.args[0])
    return False


def _device_arg(call):
    """The device a ``.to(...)`` call names (None when it only casts)."""
    for kw in call.keywords:
        if kw.arg == "device":
            return kw.value
    if call.args and not isinstance(call.args[0], ast.Constant) \
            or call.args and _is_cpu(call.args[0]):
        return call.args[0]
    return None


def _test_of(node):
    """The expression whose truth ``node`` takes, if any."""
    if isinstance(node, (ast.If, ast.While, ast.IfExp, ast.Assert)):
        return node.test
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.Not):
        return node.operand
    return None


def _mask_like(node, env, depth=0) -> bool:
    """Does ``node`` evaluate to a boolean tensor (a comparison, a mask
    combinator, an ``isnan``-style test, or a name only ever bound to
    those)?"""
    if depth > 8:
        return False
    if isinstance(node, ast.Compare):
        return True
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.Invert):
        return _mask_like(node.operand, env, depth + 1)
    if isinstance(node, ast.BinOp) and isinstance(
            node.op, (ast.BitAnd, ast.BitOr, ast.BitXor)):
        return _mask_like(node.left, env, depth + 1) \
            or _mask_like(node.right, env, depth + 1)
    if isinstance(node, ast.Call):
        name = dotted(node.func) or ""
        return name.split(".")[-1] in _MASK_FUNCS
    if isinstance(node, ast.Name):
        got = env.get(node.id)
        return isinstance(got, list) and bool(got) and all(
            _mask_like(e, env, depth + 1) for e in got)
    return False


def _scan(fi, idx, f):
    np_names = _numpy_aliases(idx)
    dtypes = _dtype_names(f.tree.body) | _dtype_names(ast.walk(fi.node))
    env = scalar_env(fi.node)
    where = f"in hot-path function {fi.qual.split(':')[1]}"
    for node in own_body_nodes(fi.node):
        test = _test_of(node)
        if test is not None and isinstance(test, ast.Call) \
                and isinstance(test.func, ast.Attribute) \
                and test.func.attr in {"any", "all"} \
                and not is_metadata_expr(test.func.value, env):
            yield finding("hot-sync", f, test,
                          f"the truth of .{test.func.attr}() reads a "
                          f"tensor to the host {where}")
        if isinstance(node, ast.Subscript):
            idxs = node.slice.elts if isinstance(node.slice, ast.Tuple) \
                else [node.slice]
            if not is_metadata_expr(node.value, env) \
                    and any(_mask_like(i, env) for i in idxs):
                yield finding(
                    "hot-sync", f, node,
                    f"indexing by a boolean mask sizes its result on the "
                    f"host {where}")
            continue
        if not isinstance(node, ast.Call):
            continue
        fn = node.func
        name = dotted(fn)
        if name in _TORCH_SYNC or name == "torch.repeat_interleave" and not \
                any(kw.arg == "output_size" for kw in node.keywords):
            yield finding("hot-sync", f, node, f"{name}() {where}")
            continue
        if name in _TENSOR_CTORS:
            dev = next((kw.value for kw in node.keywords
                        if kw.arg == "device"), None)
            if dev is not None and not _is_cpu(dev):
                yield finding(
                    "hot-sync", f, node,
                    f"{name}(..., device=) copies host data to the device "
                    f"synchronously {where}")
            continue
        if isinstance(fn, ast.Attribute):
            root = name.split(".")[0] if name else None
            if root in np_names and fn.attr in _NUMPY_FUNCS:
                yield finding(
                    "hot-sync", f, node,
                    f"np.{fn.attr}() materializes a value on host {where}")
                continue
            if root == "torch":
                continue
            meth = fn.attr
            if meth in _READ_METHODS | _SIZE_METHODS | _DRAIN_METHODS \
                    and not is_metadata_expr(fn.value, env):
                kind = ("reads to the host" if meth in _READ_METHODS else
                        "drains the stream" if meth in _DRAIN_METHODS else
                        "sizes its result on the host")
                yield finding("hot-sync", f, node,
                              f".{meth}() {kind} {where}")
                continue
            if meth == "repeat_interleave" and not any(
                    kw.arg == "output_size" for kw in node.keywords):
                yield finding("hot-sync", f, node,
                              f".repeat_interleave() sizes its result on "
                              f"the host {where}")
                continue
            if meth in _H2D_METHODS:
                yield finding("hot-sync", f, node,
                              f".{meth}() copies host data to the device "
                              f"synchronously {where}")
                continue
            if meth == "to":
                dev = _device_arg(node)
                if dev is None or _is_dtype(dev, dtypes):
                    continue
                what = "reads to the host" if _is_cpu(dev) else \
                    "copies host data to the device synchronously"
                yield finding("hot-sync", f, node, f".to() {what} {where}")
        elif isinstance(fn, ast.Name) and fn.id in _COERCIONS:
            if node.args and not all(is_metadata_expr(a, env)
                                     for a in node.args):
                yield finding(
                    "hot-sync", f, node,
                    f"{fn.id}() of a non-metadata value syncs if it holds "
                    f"a device tensor {where}")


def check(project):
    cg = project.callgraph
    reach = cg.reachable(project.config.hot_roots)
    for qual in sorted(reach):
        fi = cg.funcs[qual]
        if fi.module.startswith("repro_torch.analysis"):
            continue
        yield from _scan(fi, cg.indexes[fi.module], fi.file)


RULE = Rule(
    id="hot-sync",
    doc="host sync (.item()/.cpu()/.tolist()/nonzero/int()/H2D copies/"
        "torch.cuda.synchronize) reachable from the serve roots",
    check=check,
)
