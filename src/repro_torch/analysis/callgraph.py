"""Project call graph with repo-idiom name resolution (counterpart of
``repro.analysis.callgraph``: the same resolution order and the same
capped name fallback).

Qualified names are ``module:Outer.inner`` — class methods as
``module:Class.method``, nested defs as ``module:outer.inner``.  A call is
resolved to zero or more defs via, in order:

* local/module-level function names and ``from x import y`` aliases
  (relative imports resolved against the importing module's package),
* module-alias attributes (``import repro_torch.core.distributed as
  dist_mod`` makes ``dist_mod.tenant_stacked_answer`` precise),
* ``self.method()`` -> the enclosing class,
* ``self.attr.method()`` through attribute types inferred from
  ``self.attr = ClassName(...)`` assignments anywhere in the class,
* ``Var.method()`` through ``var = ClassName(...)`` local assignments,
* a capped unique-method-name fallback: an ``obj.m()`` whose receiver we
  can't type links to *every* def of ``m`` in the project, provided there
  are at most ``config.name_fallback_cap`` of them.  This deliberately
  over-approximates (soundness for the hot-sync rule beats precision);
  generic names past the cap are dropped instead of spraying edges.

Calling a class name reaches its ``__init__``.  Unlike the reference, a
def *referenced* as a value (an argument, a tuple member, a thread
target) is an edge too, when the reference resolves by the steps above
short of the name fallback: the port hands its ``kernels.ops.*_all``
answer functions to ``core.distributed._exchange`` as values.  A def
nested inside
another def (or a lambda) is reachable whenever its parent is — closures
on the dispatch path run on the dispatch path.
"""
from __future__ import annotations

import ast
from dataclasses import dataclass, field


@dataclass
class FuncInfo:
    qual: str                   # "module:Class.method"
    module: str
    name: str                   # bare name ("method")
    node: ast.AST               # FunctionDef / AsyncFunctionDef
    file: object                # FileModel
    cls: str | None = None      # enclosing class name, if a method
    parent: str | None = None   # enclosing def's qual, if nested
    calls: list = field(default_factory=list)   # resolved callee quals


@dataclass
class ClassInfo:
    qual: str                   # "module:Class"
    module: str
    name: str
    methods: dict = field(default_factory=dict)       # name -> func qual
    attr_types: dict = field(default_factory=dict)    # attr -> class qual


def _abs_module(file, level: int, mod: str | None) -> str:
    """Resolve a relative import against the importing file's package."""
    if level == 0:
        return mod or ""
    parts = file.module.split(".") if file.module else []
    if file.path.name != "__init__.py" and parts:
        parts = parts[:-1]                   # the module's package
    parts = parts[: len(parts) - (level - 1)] if level > 1 else parts
    return ".".join(parts + mod.split(".")) if mod else ".".join(parts)


class _ModuleIndex:
    """Per-file name tables: imports and top-level defs."""

    def __init__(self, file):
        self.file = file
        self.mod_alias: dict[str, str] = {}     # local name -> dotted module
        self.from_imports: dict[str, tuple] = {}  # local -> (module, attr)
        for node in ast.walk(file.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    self.mod_alias[a.asname or a.name.split(".")[0]] = \
                        a.name if a.asname else a.name.split(".")[0]
            elif isinstance(node, ast.ImportFrom):
                base = _abs_module(file, node.level, node.module)
                for a in node.names:
                    self.from_imports[a.asname or a.name] = (base, a.name)


class CallGraph:
    def __init__(self, project):
        self.project = project
        self.funcs: dict[str, FuncInfo] = {}
        self.classes: dict[str, ClassInfo] = {}
        self.by_name: dict[str, list] = {}      # bare name -> [func quals]
        self.indexes: dict[str, _ModuleIndex] = {}
        for f in project.files:
            self.indexes[f.module] = _ModuleIndex(f)
            self._collect(f)
        self._infer_attr_types()
        for fi in self.funcs.values():
            fi.calls = self._resolve_calls(fi)

    # -- collection ---------------------------------------------------------

    def _collect(self, f):
        def visit(node, prefix, cls, parent):
            for child in ast.iter_child_nodes(node):
                if isinstance(child, ast.ClassDef):
                    cq = f"{f.module}:{prefix}{child.name}"
                    self.classes[cq] = ClassInfo(qual=cq, module=f.module,
                                                 name=child.name)
                    visit(child, f"{prefix}{child.name}.", cq, parent)
                elif isinstance(child, (ast.FunctionDef,
                                        ast.AsyncFunctionDef)):
                    q = f"{f.module}:{prefix}{child.name}"
                    fi = FuncInfo(qual=q, module=f.module, name=child.name,
                                  node=child, file=f,
                                  cls=cls.split(":")[1] if cls else None,
                                  parent=parent)
                    self.funcs[q] = fi
                    self.by_name.setdefault(child.name, []).append(q)
                    if cls:
                        self.classes[cls].methods[child.name] = q
                    visit(child, f"{prefix}{child.name}.", None, q)
                else:
                    visit(child, prefix, cls, parent)
        visit(f.tree, "", None, None)

    def _class_qual_from_call(self, idx, call) -> str | None:
        """``ClassName(...)`` / ``mod.ClassName(...)`` -> class qual."""
        fn = call.func if isinstance(call, ast.Call) else call
        if isinstance(fn, ast.Name):
            q = f"{idx.file.module}:{fn.id}"
            if q in self.classes:
                return q
            if fn.id in idx.from_imports:
                mod, attr = idx.from_imports[fn.id]
                if f"{mod}:{attr}" in self.classes:
                    return f"{mod}:{attr}"
        elif isinstance(fn, ast.Attribute) and isinstance(fn.value, ast.Name):
            mod = idx.mod_alias.get(fn.value.id)
            if mod and f"{mod}:{fn.attr}" in self.classes:
                return f"{mod}:{fn.attr}"
        return None

    def _infer_attr_types(self):
        for fi in self.funcs.values():
            if fi.cls is None:
                continue
            ci = self.classes.get(f"{fi.module}:{fi.cls}")
            if ci is None:
                continue
            idx = self.indexes[fi.module]
            for node in ast.walk(fi.node):
                if not (isinstance(node, ast.Assign)
                        and len(node.targets) == 1):
                    continue
                t = node.targets[0]
                if (isinstance(t, ast.Attribute)
                        and isinstance(t.value, ast.Name)
                        and t.value.id == "self"
                        and isinstance(node.value, ast.Call)):
                    cq = self._class_qual_from_call(idx, node.value)
                    if cq:
                        ci.attr_types.setdefault(t.attr, cq)

    # -- resolution ---------------------------------------------------------

    def _method_of(self, class_qual: str, name: str) -> list:
        ci = self.classes.get(class_qual)
        if ci and name in ci.methods:
            return [ci.methods[name]]
        return []

    def _resolve_one(self, fi, idx, fn, fallback: bool = True) -> list:
        """Resolve a call's func expression to candidate def quals."""
        if isinstance(fn, ast.Name):
            q = f"{fi.module}:{fn.id}"
            if q in self.funcs:
                return [q]
            if q in self.classes:
                return self._method_of(q, "__init__")
            if fn.id in idx.from_imports:
                mod, attr = idx.from_imports[fn.id]
                tq = f"{mod}:{attr}"
                if tq in self.funcs:
                    return [tq]
                if tq in self.classes:
                    return self._method_of(tq, "__init__")
            return []
        if not isinstance(fn, ast.Attribute):
            return []
        recv, meth = fn.value, fn.attr
        if isinstance(recv, ast.Name):
            # module alias:  dist_mod.tenant_stacked_answer(...)
            mod = idx.mod_alias.get(recv.id)
            if mod is None and recv.id in idx.from_imports:
                m, a = idx.from_imports[recv.id]
                if f"{m}.{a}" in self.project.by_module:
                    mod = f"{m}.{a}"        # `from repro_torch.core import x`
            if mod is not None:
                tq = f"{mod}:{meth}"
                if tq in self.funcs:
                    return [tq]
                if tq in self.classes:
                    return self._method_of(tq, "__init__")
                if mod in self.project.by_module:
                    return []       # known module, unknown attr: external
            if recv.id == "self" and fi.cls is not None:
                got = self._method_of(f"{fi.module}:{fi.cls}", meth)
                if got:
                    return got
        elif (isinstance(recv, ast.Attribute)
              and isinstance(recv.value, ast.Name)
              and recv.value.id == "self" and fi.cls is not None):
            # self.attr.method() through inferred attribute types
            ci = self.classes.get(f"{fi.module}:{fi.cls}")
            if ci and recv.attr in ci.attr_types:
                got = self._method_of(ci.attr_types[recv.attr], meth)
                if got:
                    return got
        if not fallback:
            return []
        # capped bare-name fallback
        cands = self.by_name.get(meth, [])
        if 0 < len(cands) <= self.project.config.name_fallback_cap:
            return list(cands)
        return []

    def _resolve_calls(self, fi) -> list:
        idx = self.indexes[fi.module]
        out: list[str] = []
        called = set()
        for node in ast.walk(fi.node):
            if isinstance(node, ast.Call):
                called.add(id(node.func))
                out.extend(self._resolve_one(fi, idx, node.func))
        # a def referenced as a value (``kernel=(ops.f, call)``, a thread
        # target) may be called wherever the value goes: link it, when the
        # reference resolves without the name fallback
        for node in ast.walk(fi.node):
            if isinstance(node, (ast.Name, ast.Attribute)) \
                    and isinstance(node.ctx, ast.Load) \
                    and id(node) not in called:
                out.extend(self._resolve_one(fi, idx, node, fallback=False))
        # local-var typing:  pack = TenantPack(...); pack.find(...) is
        # already covered by the __init__ edge + bare-name fallback.
        # nested defs / closures run when the parent runs
        for q, other in self.funcs.items():
            if other.parent == fi.qual:
                out.append(q)
        return sorted(set(out) - {fi.qual})

    # -- queries ------------------------------------------------------------

    def reachable(self, roots) -> set:
        """BFS closure of def quals from the given root quals."""
        seen: set[str] = set()
        frontier = [r for r in roots if r in self.funcs]
        while frontier:
            q = frontier.pop()
            if q in seen:
                continue
            seen.add(q)
            frontier.extend(self.funcs[q].calls)
        return seen
