"""Rule ``kernel``: CUDA kernel constraints in the port's ``.cu`` sources
(the counterpart of the reference's ``rules/pallas.py``, which checks
``pl.pallas_call`` sites against a TPU core's VMEM).

Sizes are evaluated from the file's ``constexpr``, ``#define`` and
``enum`` integer constants only.  A dimension that names anything else (a
template parameter, a runtime argument, a struct's size) is not bounded
and counts 0, so every figure is a lower bound, and ``exact`` says
whether each of its dimensions was bounded.  Checks:

* **Static shared memory** -- per ``__global__``, the ``__shared__``
  arrays (each aligned to its element type, in declaration order) must
  stay within ``Config.static_smem_limit`` (48 KiB, the most a block may
  declare statically).
* **Dynamic shared memory** -- at each ``kernel<<<grid, block, smem,
  stream>>>``, static plus dynamic bytes must stay within
  ``Config.smem_budget_bytes`` (an H100's per-block opt-in limit), and
  dynamic bytes above 48 KiB need a ``cudaFuncSetAttribute(kernel,
  cudaFuncAttributeMaxDynamicSharedMemorySize, ...)`` earlier in the same
  launcher.  Both fire on the lower bound: a finding is a definite
  violation.
* **Kernel bodies** -- the sources held bit for bit against XLA's unfused
  rounding (``Config.no_fma_sources``) spell no explicit FMA (``fmaf``,
  ``fma``, ``__fmaf_r*``, ``__fma_r*``); those searching in f32 key space
  (``F32_ONLY_SOURCES``) name no ``double``; and the build module's
  ``NVCC_FLAGS`` keep ``REQUIRED_NVCC_FLAGS`` (``-fmad=false``), so
  that nvcc contracts nothing on its own.

:func:`figures` gives the per-kernel and per-launch figures, which
``chip_smoke.py`` holds against the built libraries' own resource usage
and the card's opt-in limit.
"""
from __future__ import annotations

import ast
import re
from dataclasses import dataclass
from pathlib import Path

from ..engine import Finding, finding
from .common import Rule

DYNAMIC_DEFAULT_LIMIT = 49_152     # dynamic bytes a launch may use unasked
# The sources searching in f32 key space, where no double may appear; the
# module whose NVCC_FLAGS build every source, and the flags that keep nvcc
# from contracting a*b + c on its own.
F32_ONLY_SOURCES = ("lookup.cu",)
NVCC_FLAGS_MODULE = "repro_torch.kernels.build"
REQUIRED_NVCC_FLAGS = ("-fmad=false",)

_FMA_RE = re.compile(r"\b(fmaf?|__fmaf?_(?:ieee_)?r[nzud])\s*\(")
_SIZES = {
    "char": 1, "bool": 1, "int8_t": 1, "uint8_t": 1, "unsigned char": 1,
    "short": 2, "int16_t": 2, "uint16_t": 2, "unsigned short": 2,
    "__half": 2, "half": 2, "__nv_bfloat16": 2, "int": 4, "unsigned": 4,
    "unsigned int": 4, "int32_t": 4, "uint32_t": 4, "float": 4,
    "long long": 8, "unsigned long long": 8, "int64_t": 8, "uint64_t": 8,
    "size_t": 8, "double": 8, "float2": 8, "int2": 8, "uint2": 8,
    "float4": 16, "int4": 16, "uint4": 16, "double2": 16,
}
_INT_TYPE = r"(?:(?:unsigned|signed|long|short|int|char|size_t|u?int\d+_t)\b\s*)+"
_CONSTEXPR_RE = re.compile(
    rf"\bconstexpr\s+{_INT_TYPE}([A-Za-z_]\w*)\s*=\s*([^;{{}}]+);")
_ENUM_RE = re.compile(r"\benum\b(?:\s+class)?(?:\s+\w+)?(?:\s*:[\w\s]+)?"
                      r"\s*\{([^}]*)\}")
_LAUNCH_RE = re.compile(r"([A-Za-z_]\w*)\s*(?:<[^;{}]*?>)?\s*<<<(.*?)>>>",
                        re.S)
_OPS = {ast.Add: lambda x, y: x + y, ast.Sub: lambda x, y: x - y,
        ast.Mult: lambda x, y: x * y, ast.FloorDiv: lambda x, y: x // y,
        ast.Mod: lambda x, y: x % y, ast.LShift: lambda x, y: x << y,
        ast.RShift: lambda x, y: x >> y, ast.BitOr: lambda x, y: x | y,
        ast.BitAnd: lambda x, y: x & y}


def strip_cuda(source: str) -> tuple[str, dict, list]:
    """The source with comments, string and character literals and
    preprocessor lines blanked (newlines kept), its object-like
    ``#define`` values, and the (line, text) of every ``//`` comment (where
    the engine reads the pragmas)."""
    out = list(source)
    defines: dict[str, str] = {}
    comments: list = []
    i, n = 0, len(source)

    def line_at(k):
        return source.count("\n", 0, k) + 1

    def blank(a, b):
        for k in range(a, b):
            if out[k] != "\n":
                out[k] = " "

    at_line_start = True
    while i < n:
        c = source[i]
        if at_line_start and c == "#":
            j = i
            while True:
                e = source.find("\n", j)
                e = n if e < 0 else e
                if source[j:e].rstrip().endswith("\\") and e < n:
                    j = e + 1
                    continue
                break
            m = re.match(r"#\s*define\s+([A-Za-z_]\w*)(\s+|$)(.*)",
                         source[i:e].replace("\\\n", " "), re.S)
            if m and m.group(2) is not None and "(" != source[
                    i + m.end(1):i + m.end(1) + 1]:
                defines[m.group(1)] = m.group(3).split("//")[0].strip()
            c0 = source.find("//", i, e)
            if c0 >= 0:
                comments.append((line_at(c0), source[c0:e]))
            blank(i, e)
            i = e
            continue
        if c == "\n":
            at_line_start = True
            i += 1
            continue
        if not c.isspace():
            at_line_start = False
        if source.startswith("//", i):
            j = source.find("\n", i)
            j = n if j < 0 else j
            comments.append((line_at(i), source[i:j]))
            blank(i, j)
            i = j
        elif source.startswith("/*", i):
            j = source.find("*/", i + 2)
            j = n if j < 0 else j + 2
            blank(i, j)
            i = j
        elif c in "\"'":
            j = i + 1
            while j < n and source[j] != c and source[j] != "\n":
                j += 2 if source[j] == "\\" else 1
            blank(i, min(j + 1, n))
            i = j + 1
        else:
            i += 1
    return "".join(out), defines, comments



def _close(text: str, i: int) -> int:
    """Index of the bracket closing the one at ``text[i]``."""
    pair = {"(": ")", "{": "}", "[": "]"}[text[i]]
    depth = 0
    for j in range(i, len(text)):
        if text[j] == text[i]:
            depth += 1
        elif text[j] == pair:
            depth -= 1
            if depth == 0:
                return j
    return len(text) - 1


def _split_args(s: str) -> list:
    """``s`` split at its top-level commas."""
    out, depth, cur = [], 0, []
    for c in s:
        if c in "([{":
            depth += 1
        elif c in ")]}":
            depth -= 1
        if c == "," and depth == 0:
            out.append("".join(cur))
            cur = []
        else:
            cur.append(c)
    out.append("".join(cur))
    return [a.strip() for a in out]


def constants(text: str, defines: dict) -> dict:
    """name -> expression text of the file's integer ``constexpr``,
    object-like ``#define`` and ``enum`` constants.  A name given two
    different expressions (a local constant reused in several kernels)
    maps to None: it is not bounded."""
    out: dict = {}

    def put(name, expr):
        expr = expr.strip()
        out[name] = expr if out.get(name, expr) == expr else None
    for name, expr in defines.items():
        put(name, expr)
    for m in _CONSTEXPR_RE.finditer(text):
        put(m[1], m[2])
    for m in _ENUM_RE.finditer(text):
        prev = None
        for item in _split_args(m[1]):
            if not item:
                continue
            name, _, expr = item.partition("=")
            expr = expr or (f"({prev}) + 1" if prev else "0")
            put(name.strip(), expr)
            prev = name.strip()
    return out


def value(expr: str, consts: dict, _seen=()) -> int | None:
    """The integer value of a C expression over ``consts`` (``+ - * / %
    << >> | &``, parentheses, ``sizeof`` of a base type), or None."""
    if expr is None:
        return None
    expr = re.sub(r"sizeof\s*\(\s*([\w\s]+?)\s*\)",
                  lambda m: str(_SIZES.get(m[1], "None")), expr)
    expr = re.sub(r"\b(0[xX][0-9a-fA-F]+|\d+)[uUlL]+\b", r"\1", expr)
    try:
        tree = ast.parse(expr.replace("/", "//"), mode="eval").body
    except SyntaxError:
        return None

    def ev(n):
        if isinstance(n, ast.Constant) and type(n.value) is int:
            return n.value
        if isinstance(n, ast.Name) and n.id in consts \
                and n.id not in _seen:
            return value(consts[n.id], consts, _seen + (n.id,))
        if isinstance(n, ast.UnaryOp) and isinstance(n.op, ast.USub):
            v = ev(n.operand)
            return None if v is None else -v
        if isinstance(n, ast.BinOp) and type(n.op) in _OPS:
            x, y = ev(n.left), ev(n.right)
            if x is None or y is None:
                return None
            try:
                return _OPS[type(n.op)](x, y)
            except (ZeroDivisionError, ValueError):
                return None
        return None
    return ev(tree)


@dataclass
class KernelSmem:
    """A ``__global__``'s static shared memory: ``bytes`` a lower bound,
    ``exact`` where every dimension was bounded."""
    file: str
    kernel: str
    line: int
    bytes: int
    exact: bool


@dataclass
class Launch:
    """One ``<<<>>>`` site: the kernel's static bytes (a lower bound) and
    the dynamic bytes (None where the constants do not bound them)."""
    file: str
    line: int
    kernel: str
    static: int
    dynamic: int | None
    has_attribute: bool


def _line(text: str, i: int) -> int:
    return text.count("\n", 0, i) + 1


def _static_smem(body: str, consts: dict) -> tuple[int, bool]:
    """(bytes, exact) of the static ``__shared__`` arrays of a body."""
    off, exact = 0, True
    for m in re.finditer(r"\b__shared__\b([^;]*);", body):
        start = max(body.rfind(c, 0, m.start()) for c in ";{}")
        if re.search(r"\bextern\b", body[start + 1:m.start()]):
            continue
        stmt = body[start + 1:m.start()] + m[1]
        al = re.search(r"\balignas\s*\(([^)]*)\)", stmt)
        decl = re.sub(r"\b(alignas|__align__)\s*\([^)]*\)|\b(const|static|"
                      r"volatile)\b", " ", m[1]).strip()
        parts = _split_args(decl)
        head = re.match(r"(.*?)\b([A-Za-z_]\w*)\s*((?:\[[^\]]*\]\s*)*)$",
                        parts[0], re.S)
        if head is None:
            exact = False
            continue
        size = _SIZES.get(" ".join(head[1].split()))
        align = value(al[1], consts) if al else size
        for part in [head[2] + head[3]] + parts[1:]:
            dims = re.findall(r"\[([^\]]*)\]", part)
            n = size
            for d in dims:
                v = value(d, consts)
                n = None if n is None or v is None else n * v
            if n is None:
                exact = False
                continue
            if align:
                off = -(-off // align) * align
            off += n
    return off, exact


def _bodies(text: str) -> list:
    """(start, end) of every function or struct body: a brace opened
    outside any other, namespaces and ``extern "C"`` blocks being
    transparent."""
    out, stack = [], []
    for i, c in enumerate(text):
        if c == "{":
            start = max(text.rfind(x, 0, i) for x in ";{}")
            open_ = re.search(r"\b(namespace\b[\w\s:]*|extern\s*)$",
                              text[start + 1:i]) is not None
            if not open_ and not any(not o for _, o in stack):
                out.append([i, len(text)])
            stack.append((len(out) - 1, open_))
        elif c == "}" and stack:
            k, open_ = stack.pop()
            if not open_ and not any(not o for _, o in stack):
                out[k][1] = i
    return [tuple(b) for b in out]


def figures(f) -> tuple[list, list]:
    """Every ``__global__``'s static shared memory and every launch's
    static and dynamic bytes, for one CUDA source (a ``FileModel``)."""
    text, defines, _ = strip_cuda(f.source)
    consts = constants(text, defines)
    rel = str(f.rel)
    kernels = []
    for m in re.finditer(r"\b__global__\b", text):
        k = m.end()
        while True:                 # past __launch_bounds__(...)
            p = text.find("(", k)
            word = re.search(r"([A-Za-z_]\w*)\s*$", text[k:p])
            if word is None or word[1] != "__launch_bounds__":
                break
            k = _close(text, p) + 1
        brace, semi = text.find("{", _close(text, p)), \
            text.find(";", _close(text, p))
        if word is None or brace < 0 or 0 <= semi < brace:
            continue
        nbytes, exact = _static_smem(text[brace:_close(text, brace)], consts)
        kernels.append(KernelSmem(rel, word[1], _line(text, m.start()),
                                  nbytes, exact))
    static = {}
    for ks in kernels:
        static[ks.kernel] = min(static.get(ks.kernel, ks.bytes), ks.bytes)
    bodies = _bodies(text)
    launches = []
    for m in _LAUNCH_RE.finditer(text):
        lo = max((b for b in bodies if b[0] < m.start() < b[1]),
                 default=(0, 0))[0]
        before = text[lo:m.start()]
        name = m[1]
        alias = re.search(rf"\bauto\s+{name}\s*=\s*([A-Za-z_]\w*)", before)
        kname = alias[1] if alias else name
        args = _split_args(m[2])
        dyn = value(args[2], consts) if len(args) > 2 else 0
        attr = False
        for a in re.finditer(r"\bcudaFuncSetAttribute\s*\(", before):
            fa = _split_args(before[a.end():_close(before, a.end() - 1)])
            attr |= fa[0].split("<")[0].strip() in (name, kname) and fa[1:2] \
                == ["cudaFuncAttributeMaxDynamicSharedMemorySize"]
        launches.append(Launch(rel, _line(text, m.start()), kname,
                               static.get(kname, 0), dyn, attr))
    return kernels, launches


# -- the rule ---------------------------------------------------------------
def _cu_finding(f, line: int, message: str) -> Finding:
    return Finding(rule="kernel", path=f.rel, line=line, message=message)


def _nvcc_flags(f) -> tuple:
    """(assign node, constant strings) of a module's NVCC_FLAGS."""
    for node in f.tree.body:
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "NVCC_FLAGS"
                for t in node.targets):
            return node, {e.value for e in ast.walk(node.value)
                          if isinstance(e, ast.Constant)
                          and isinstance(e.value, str)}
    return None, set()


def check(project):
    cfg = project.config
    for f in project.cuda:
        kernels, launches = figures(f)
        for k in kernels:
            if k.bytes > cfg.static_smem_limit:
                yield _cu_finding(
                    f, k.line,
                    f"__global__ {k.kernel} declares "
                    f"{'' if k.exact else 'at least '}{k.bytes} bytes of static __shared__ memory, above "
                    f"the static limit {cfg.static_smem_limit}")
        for la in launches:
            total = la.static + (la.dynamic or 0)
            if total > cfg.smem_budget_bytes:
                yield _cu_finding(
                    f, la.line,
                    f"launch of {la.kernel} uses at least {total} bytes of "
                    f"shared memory (static {la.static} + dynamic "
                    f"{la.dynamic}), above the budget "
                    f"{cfg.smem_budget_bytes}")
            if (la.dynamic or 0) > DYNAMIC_DEFAULT_LIMIT \
                    and not la.has_attribute:
                yield _cu_finding(
                    f, la.line,
                    f"launch of {la.kernel} asks {la.dynamic} dynamic "
                    f"bytes, above {DYNAMIC_DEFAULT_LIMIT}, with no "
                    f"cudaFuncSetAttribute(..., "
                    f"cudaFuncAttributeMaxDynamicSharedMemorySize, ...) of "
                    f"that kernel before it")
        name = Path(str(f.rel)).name
        text = strip_cuda(f.source)[0]
        if name in cfg.no_fma_sources:
            for m in _FMA_RE.finditer(text):
                yield _cu_finding(
                    f, _line(text, m.start()),
                    f"explicit FMA {m[1]}() in {name}, whose kernels are "
                    f"held bit for bit against XLA's unfused rounding")
        if name in F32_ONLY_SOURCES:
            for m in re.finditer(r"\bdouble\b", text):
                yield _cu_finding(
                    f, _line(text, m.start()),
                    f"double in {name}, whose kernels search in f32 key "
                    f"space")
    if project.cuda:
        flags_mod = project.by_module.get(NVCC_FLAGS_MODULE)
        if flags_mod is not None:
            node, flags = _nvcc_flags(flags_mod)
            for need in REQUIRED_NVCC_FLAGS:
                if need not in flags:
                    yield finding(
                        "kernel", flags_mod, node or flags_mod.tree,
                        f"NVCC_FLAGS lacks {need}: nvcc would contract "
                        f"a*b + c into FMAs on its own")


RULE = Rule(
    id="kernel",
    doc="CUDA shared memory (static <= 48 KiB, static + dynamic <= the "
        "H100's opt-in limit, cudaFuncSetAttribute above 48 KiB), no "
        "explicit FMA or double where kernels are bit-exact, -fmad=false",
    check=check,
)
