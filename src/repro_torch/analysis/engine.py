"""tracelint engine: project model, pragma scanning, rule runner, CLI
(counterpart of ``repro.analysis.engine``).

The engine owns everything rule-agnostic: walking the analyzed roots into
a :class:`Project` of parsed files (with module names resolved the way the
repo imports them -- ``src/repro_torch/...`` -> ``repro_torch...``,
``chip_smoke.py`` -> ``chip_smoke``), the CUDA sources (``*.cu``) found
under the same roots, scanning comments for suppression pragmas
(tokenize-based for Python, so strings that merely *contain* a pragma
spelling do not suppress; ``//`` comments for CUDA), matching findings
against pragmas, and rendering/exiting.  Rules live in
``repro_torch.analysis.rules`` and receive the whole project, so
cross-module facts (call-graph reachability, the nvcc flags of
``kernels/build.py`` beside the ``.cu`` sources) are first-class.
"""
from __future__ import annotations

import argparse
import ast
import io
import re
import tokenize
from dataclasses import dataclass, field, replace
from pathlib import Path

# -- pragmas ----------------------------------------------------------------
# Grammar (see package docstring): the general form names a rule id in
# brackets and a reason in parens; the "sync" spelling aliases hot-sync.
_PRAGMA_RE = re.compile(r"tracelint:\s*ok\[([A-Za-z0-9_-]+)\]\(([^)]*)\)")
_SYNC_RE = re.compile(r"sync:\s*ok\(([^)]*)\)")
# Malformed spellings that were clearly *meant* as pragmas must fail
# loud, not silently un-suppress: either marker word followed by the
# approval token but missing its [rule]/(reason) payload.
_NEAR_PRAGMA_RE = re.compile(r"(tracelint|sync):\s*ok")

PRAGMA_RULE = "pragma"          # rule id for pragma-grammar violations


@dataclass(frozen=True)
class Finding:
    rule: str
    path: Path                  # as given (relative to the analysis root)
    line: int
    message: str
    suppressed: str | None = None    # the pragma reason, when suppressed

    def render(self) -> str:
        tag = f" (suppressed: {self.suppressed})" if self.suppressed else ""
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}{tag}"


@dataclass
class Config:
    """Analyzer knobs (defaults encode the port's contracts)."""
    # Call-graph roots of the serving hot path ("module:Qual.name"): the
    # reference's four front-end roots and the single index's serve verbs.
    hot_roots: tuple = (
        "repro_torch.serve.frontend:BatchingFrontend._dispatch",
        "repro_torch.serve.frontend:BatchingFrontend._resolve",
        "repro_torch.serve.frontend:TenantPack.find",
        "repro_torch.serve.frontend:TenantPack.find_range",
        "repro_torch.api:Index.find",
        "repro_torch.api:Index.find_range",
    )
    # Shared memory a block may use on an H100: the opt-in limit of
    # static plus dynamic bytes, and the most a kernel may declare
    # statically (dynamic bytes above it need cudaFuncSetAttribute).
    smem_budget_bytes: int = 232_448
    static_smem_limit: int = 49_152
    # Identifiers that mark an expression as key-valued for f32-cast checks.
    key_name_re: str = (r"(^|_)(k|kf|kn|kp|q|qf|ql|qh|qm|rq|dk|dkp|key|keys|"
                        r"queries|splits|q_lo|q_hi|lo_keys|hi_keys)(_|$)|key")
    # Module prefixes where f32 key casts are sanctioned: the kernel
    # boundary (every wrapper sits behind the f32_exact gate) and the chip
    # harness (its casts build reference answers and f32-exact queries).
    f32_cast_ok_modules: tuple = ("repro_torch.kernels", "chip_smoke")
    # CUDA sources held bit for bit against XLA's unfused rounding: no
    # explicit FMA in them (flash.cu's deliberate __fmaf_rn is not held
    # so).
    no_fma_sources: tuple = ("lookup.cu", "hist.cu", "linfit.cu",
                             "ksdist.cu")
    # Ambiguous-method-call fallback: an `obj.m()` call with an unknown
    # receiver type links to every def of `m` when there are at most this
    # many (past it the name is too generic to mean anything).
    name_fallback_cap: int = 6


@dataclass
class FileModel:
    path: Path                  # absolute
    rel: Path                   # relative to analysis root (for display)
    module: str                 # dotted import name ("repro_torch.api")
    tree: ast.Module | None     # None for a CUDA source
    source: str
    # line -> {rule_id: reason} suppression pragmas on that line
    pragmas: dict = field(default_factory=dict)
    pragma_errors: list = field(default_factory=list)   # (line, message)


@dataclass
class Project:
    root: Path
    files: list                 # Python FileModels
    config: Config
    cuda: list = field(default_factory=list)    # CUDA FileModels

    def __post_init__(self):
        self.by_module = {f.module: f for f in self.files}
        self._callgraph = None

    @property
    def callgraph(self):
        """Lazily built project call graph (rules share one instance)."""
        if self._callgraph is None:
            from .callgraph import CallGraph
            self._callgraph = CallGraph(self)
        return self._callgraph


def _match_pragmas(comments) -> tuple[dict, list]:
    """(line, comment text) pairs -> ({line: {rule: reason}}, errors)."""
    pragmas: dict[int, dict] = {}
    errors: list[tuple[int, str]] = []
    for line, text in comments:
        matched = False
        for m in _PRAGMA_RE.finditer(text):
            matched = True
            rule, reason = m.group(1), m.group(2).strip()
            if not reason:
                errors.append((line, f"pragma ok[{rule}] carries no reason"))
            else:
                pragmas.setdefault(line, {})[rule] = reason
        for m in _SYNC_RE.finditer(text):
            matched = True
            reason = m.group(1).strip()
            if not reason:
                errors.append((line, "sync: ok() carries no reason"))
            else:
                pragmas.setdefault(line, {})["hot-sync"] = reason
        if not matched and _NEAR_PRAGMA_RE.search(text):
            errors.append(
                (line, "malformed pragma: want 'tracelint: ok[rule](reason)'"
                       " or 'sync: ok(reason)'"))
    return pragmas, errors


def _scan_pragmas(source: str) -> tuple[dict, list]:
    """Comment-token pragma scan -> ({line: {rule: reason}}, errors)."""
    try:
        tokens = tokenize.generate_tokens(io.StringIO(source).readline)
        comments = [(t.start[0], t.string) for t in tokens
                    if t.type == tokenize.COMMENT]
    except tokenize.TokenError:
        comments = []
    return _match_pragmas(comments)


def _scan_cuda_pragmas(source: str) -> tuple[dict, list]:
    """The pragma grammar in a CUDA source's ``//`` comments."""
    from .rules.kernel import strip_cuda
    return _match_pragmas(strip_cuda(source)[2])


def _module_name(rel: Path) -> str:
    """Dotted import name matching how the repo imports the file
    (``src`` is the PYTHONPATH root; top-level scripts import as-is)."""
    parts = list(rel.with_suffix("").parts)
    if parts and parts[0] == "src":
        parts = parts[1:]
    if parts and parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts)


def load_project(paths: list, config: Config | None = None,
                 root: Path | None = None) -> Project:
    """Parse every ``.py`` and read every ``.cu`` under the given
    files/directories."""
    config = config or Config()
    root = (root or Path.cwd()).resolve()
    seen: set[Path] = set()
    files: list[FileModel] = []
    cuda: list[FileModel] = []
    queue: list[Path] = []
    for p in paths:
        p = Path(p).resolve()
        queue += sorted([*p.rglob("*.py"), *p.rglob("*.cu")]) \
            if p.is_dir() else [p]
    for path in queue:
        if path in seen:
            continue
        seen.add(path)
        source = path.read_text()
        try:
            rel = path.relative_to(root)
        except ValueError:
            rel = path
        if path.suffix == ".cu":
            pragmas, errors = _scan_cuda_pragmas(source)
            cuda.append(FileModel(path=path, rel=rel, module=str(rel),
                                  tree=None, source=source, pragmas=pragmas,
                                  pragma_errors=errors))
            continue
        try:
            tree = ast.parse(source)
        except SyntaxError as exc:
            raise SystemExit(f"tracelint: cannot parse {path}: {exc}") \
                from exc
        pragmas, errors = _scan_pragmas(source)
        files.append(FileModel(path=path, rel=rel, module=_module_name(rel),
                               tree=tree, source=source, pragmas=pragmas,
                               pragma_errors=errors))
    return Project(root=root, files=files, config=config, cuda=cuda)


def _apply_pragmas(f: FileModel, findings: list) -> list:
    """Mark findings suppressed by a pragma on any line of the flagged
    statement or the line directly above it."""
    out = []
    for fd in findings:
        span = getattr(fd, "_span", (fd.line, fd.line))
        reason = None
        for line in range(span[0] - 1, span[1] + 1):
            got = f.pragmas.get(line, {}).get(fd.rule)
            if got is not None:
                reason = got
                break
        if reason:
            fd = replace(fd, suppressed=reason)
            object.__setattr__(fd, "_span", span)
        out.append(fd)
    return out


def finding(rule: str, f: FileModel, node: ast.AST, message: str) -> Finding:
    """Build a Finding anchored to ``node`` (records the statement span so
    trailing pragmas on any physical line of the statement match)."""
    fd = Finding(rule=rule, path=f.rel, line=getattr(node, "lineno", 1),
                 message=message)
    object.__setattr__(fd, "_span", (getattr(node, "lineno", 1),
                                     getattr(node, "end_lineno",
                                             getattr(node, "lineno", 1))))
    return fd


def span(fd: Finding) -> tuple:
    """First and last line of the construct a finding flags."""
    return getattr(fd, "_span", (fd.line, fd.line))


def analyze(paths: list, config: Config | None = None,
            root: Path | None = None) -> list:
    """Run every rule over the project; returns all findings (suppressed
    ones carry their pragma reason).  Pragma-grammar violations are
    findings of rule ``pragma`` and are never suppressible."""
    from .rules import KNOWN_RULE_IDS, RULES
    project = load_project(paths, config, root)
    findings: list[Finding] = []
    every = project.files + project.cuda
    by_rel = {str(f.rel): f for f in every}
    per_file: dict[str, list] = {str(f.rel): [] for f in every}
    for rule in RULES:
        for fd in rule.check(project):
            key = str(fd.path)
            if key in by_rel:
                per_file[key].append(fd)
            else:
                findings.append(fd)
    for f in every:
        findings.extend(_apply_pragmas(f, per_file[str(f.rel)]))
        for line, msg in f.pragma_errors:
            findings.append(Finding(rule=PRAGMA_RULE, path=f.rel, line=line,
                                    message=msg))
        for line, by_rule in f.pragmas.items():
            for rid in by_rule:
                if rid not in KNOWN_RULE_IDS:
                    findings.append(Finding(
                        rule=PRAGMA_RULE, path=f.rel, line=line,
                        message=f"pragma names unknown rule id {rid!r}"))
    findings.sort(key=lambda fd: (str(fd.path), fd.line, fd.rule))
    return findings


def main(argv: list | None = None) -> int:
    from .rules import NOT_PORTED, RULES
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="tracelint for the PyTorch/CUDA port: host-sync/"
                    "retrace/f32-cast/CUDA kernel static analysis (package "
                    "docstring has the rule and pragma reference)")
    ap.add_argument("paths", nargs="*", default=[],
                    help="files or directories to analyze")
    ap.add_argument("--smem-budget", type=int, default=None, metavar="BYTES",
                    help="shared memory a block may use, static plus dynamic "
                         "(default 232448, an H100's opt-in limit)")
    ap.add_argument("--list-rules", action="store_true",
                    help="print rule ids and one-line docs, then exit")
    ap.add_argument("-q", "--quiet", action="store_true",
                    help="suppress the per-rule summary and suppressed "
                         "findings; print only violations")
    args = ap.parse_args(argv)

    if args.list_rules:
        for rule in RULES:
            print(f"{rule.id:12s} {rule.doc}")
        for rid, why in NOT_PORTED.items():
            print(f"{rid:12s} (not ported) {why}")
        return 0
    if not args.paths:
        ap.error("no paths given (try: src/repro_torch chip_smoke.py "
                 "time_verbs.py examples/index_service_torch.py)")

    config = Config()
    if args.smem_budget is not None:
        config.smem_budget_bytes = args.smem_budget
    findings = analyze(args.paths, config)
    bad = [fd for fd in findings if fd.suppressed is None]
    ok = [fd for fd in findings if fd.suppressed is not None]
    for fd in bad:
        print(fd.render())
    if not args.quiet:
        for fd in ok:
            print(fd.render())
        counts: dict[str, int] = {}
        for fd in bad:
            counts[fd.rule] = counts.get(fd.rule, 0) + 1
        summary = ", ".join(f"{k}={v}" for k, v in sorted(counts.items())) \
            or "none"
        print(f"tracelint: {len(bad)} finding(s) [{summary}], "
              f"{len(ok)} suppressed")
    return 1 if bad else 0
