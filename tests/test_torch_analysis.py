"""The port's static analyzer (``repro_torch.analysis``), modelled on
``tests/test_analysis.py``.

* Every rule gets positive fixtures (the finding fires, with the right rule
  id and line) and negative ones (the sanctioned spelling stays clean),
  one parametrised case a torch spelling: the hot-sync reads, drains,
  host-sized ops, host-to-device copies, numpy materialization and the
  metadata exemptions; the retrace constructors on a lambda, in a loop and
  in a plain def against the memoized and dict-cache idioms; the f32-cast
  spellings against the kernel boundary and the gate; and ``.cu`` fixtures
  for the kernel rule (static ``__shared__`` above 48 KiB, a dynamic launch
  above 48 KiB with no attribute, one above the budget, an FMA and a
  ``double`` in ``lookup.cu``, ``NVCC_FLAGS`` without ``-fmad=false``).
  Fixtures are miniature trees under ``tmp_path/src`` so that module names
  resolve as in the repo (``src/repro_torch/serve/frontend.py`` ->
  ``repro_torch.serve.frontend``), which the hot-path roots key on.
* The pragma grammar in ``#`` and ``//`` comments: an empty reason, an
  unknown rule id, a malformed spelling.
* Parity with the reference: on one fixture tree the port's
  ``_scan_pragmas``, its call-graph reachability from the same roots and
  its f32-cast findings on the numpy spellings equal ``repro.analysis``'s.
* Seeded violations: the real ``serve/frontend.py`` and ``kernels/ops.py``
  with their pragmas stripped fail hot-sync in ``_resolve`` and
  ``_reads``; the real port tree is clean, every suppression with its
  reason; the kernel rule's figures of the real CUDA sources, which
  ``chip_smoke.py`` holds against the built libraries.
* ``repro_torch/analysis`` imports neither ``jax`` nor ``repro``; the CLI's
  exit codes, ``--list-rules`` and ``--smem-budget``.

Pure AST: the suite takes seconds.
"""
from __future__ import annotations

import ast
import importlib.util
import re
import shutil
import textwrap
from pathlib import Path

import pytest

from repro_torch.analysis import Config, analyze
from repro_torch.analysis import engine as teng
from repro_torch.analysis.engine import main as cli_main
from repro_torch.analysis.rules import kernel as tkernel

REPO = Path(__file__).resolve().parents[1]
PORT_PATHS = ["src/repro_torch", "chip_smoke.py", "time_verbs.py",
              "examples/index_service_torch.py"]


def _write(tmp, rel, src):
    p = tmp / rel
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(textwrap.dedent(src))
    return p


def _run(tmp, config=None):
    return analyze([tmp / "src"], config, root=tmp)


def _bad(findings, rule=None):
    return [f for f in findings if f.suppressed is None
            and (rule is None or f.rule == rule)]


# -- hot-sync ---------------------------------------------------------------

def _hot(body: str) -> str:
    """A front-end whose ``_dispatch`` runs ``body`` (line 8 onward) on
    ``x``, a tensor, and ``a``, a host array."""
    return ("import numpy as np\n"
            "import torch\n"
            "\n"
            "\n"
            "class BatchingFrontend:\n"
            "    def _dispatch(self, x, a, ev, dev, n: int):\n"
            "        r = None\n"
            + textwrap.indent(textwrap.dedent(body), " " * 8)
            + "\n        return r\n")


HOT_POSITIVE = {
    "item": "r = x.item()",
    "tolist": "r = x.tolist()",
    "cpu": "r = x.cpu()",
    "numpy": "r = x.numpy()",
    "to-cpu": "r = x.to(\"cpu\")",
    "to-cpu-device": "r = x.to(torch.device(\"cpu\"))",
    "cuda-synchronize": "torch.cuda.synchronize()",
    "event-synchronize": "ev.synchronize()",
    "torch-nonzero": "r = torch.nonzero(x)",
    "method-nonzero": "r = x.nonzero()",
    "unique": "r = torch.unique(x)",
    "masked-select": "r = torch.masked_select(x, x > 0)",
    "bincount": "r = torch.bincount(x)",
    "repeat-interleave": "r = torch.repeat_interleave(x, x)",
    "equal": "r = torch.equal(x, x)",
    "mask-index": "r = x[x > 0]",
    "mask-name-index": "m = torch.isnan(x)\nr = x[~m]",
    "np-asarray": "r = np.asarray(x)",
    "np-flatnonzero": "r = np.flatnonzero(a)",
    "int": "r = int(x.sum())",
    "float": "r = float(x)",
    "bool": "r = bool(x.all())",
    "truth-any": "r = 1 if x.any() else 0",
    "tensor-to-device": "r = torch.tensor([1, 2], device=dev)",
    "as-tensor-to-device": "r = torch.as_tensor(a, device=dev)",
    "to-device": "r = torch.from_numpy(a).to(dev)",
    "cuda": "r = x.cuda()",
    "copy": "x.copy_(r)",
}

HOT_NEGATIVE = {
    "nonzero-static": "r = torch.nonzero_static(x, size=4)",
    "repeat-output-size": "r = torch.repeat_interleave(x, 2, output_size=8)",
    "metadata": "r = [int(x.shape[0]), x.numel(), int(x.dim()), len(x),\n"
                "     x.device, x.dtype, int(n), bool(n > 4), x.size(0)]",
    "cast": "r = x.to(torch.float32)",
    "cast-kw": "r = x.to(dtype=torch.int64)",
    "to-cpu-tensor": "r = torch.as_tensor(a, device=\"cpu\")",
    "host-mask": "w = np.zeros(4)\nr = w[w < 2]",
    "string-compare": "r = int(dev == \"cuda\")",
    "device-ops": "r = torch.searchsorted(x, x).argsort() + 1",
}


@pytest.mark.parametrize("case", sorted(HOT_POSITIVE))
def test_hot_sync_flags_each_torch_spelling(tmp_path, case):
    _write(tmp_path, "src/repro_torch/serve/frontend.py",
           _hot(HOT_POSITIVE[case]))
    bad = _bad(_run(tmp_path), "hot-sync")
    assert bad, case
    assert all(f.line >= 8 and "_dispatch" in f.message for f in bad), bad


@pytest.mark.parametrize("case", sorted(HOT_NEGATIVE))
def test_hot_sync_exempts_metadata_and_device_ops(tmp_path, case):
    _write(tmp_path, "src/repro_torch/serve/frontend.py",
           _hot(HOT_NEGATIVE[case]))
    assert _bad(_run(tmp_path), "hot-sync") == [], case


def test_hot_sync_reachability_and_roots(tmp_path):
    # the single index's serve verbs are roots too; a cold helper is not
    _write(tmp_path, "src/repro_torch/api.py", """\
        class Index:
            def find(self, q):
                return _lookup(q)

        def _lookup(q):
            return q.tolist()           # line 6: reached from Index.find

        def cold_helper(x):
            return x.item()             # unreachable: clean
        """)
    bad = _bad(_run(tmp_path), "hot-sync")
    assert [f.line for f in bad] == [6]
    assert "_lookup" in bad[0].message


def test_hot_sync_follows_function_values(tmp_path):
    # a def handed on as a value (kernels.ops.*_all to _exchange) is an
    # edge of the port's call graph
    _write(tmp_path, "src/repro_torch/serve/frontend.py", """\
        from ..kernels import ops

        class TenantPack:
            def find(self, q):
                return _exchange(q, kernel=(ops.answer_all, None))

        def _exchange(q, kernel):
            return kernel[0](q)
        """)
    _write(tmp_path, "src/repro_torch/kernels/ops.py", """\
        def answer_all(q):
            return q.cpu()              # line 2
        """)
    bad = _bad(_run(tmp_path), "hot-sync")
    assert [(Path(f.path).name, f.line) for f in bad] == [("ops.py", 2)]


def test_hot_sync_pragma_suppresses_with_reason(tmp_path):
    _write(tmp_path, "src/repro_torch/serve/frontend.py", """\
        class BatchingFrontend:
            def _resolve(self, inf):
                # sync: ok(the host read of a batch's answers)
                found = inf.found.cpu().numpy()
                rank = inf.rank.cpu()  # tracelint: ok[hot-sync](rides it)
                return found, rank
        """)
    findings = _run(tmp_path)
    assert _bad(findings) == []
    reasons = {f.suppressed for f in findings if f.rule == "hot-sync"}
    assert reasons == {"the host read of a batch's answers", "rides it"}


# -- retrace ----------------------------------------------------------------

RETRACE_POSITIVE = {
    "compile-lambda": ("import torch\n"
                       "f = torch.compile(lambda x: x + 1)\n", 2),
    "cdll-in-loop": ("import ctypes\n"
                     "libs = [ctypes.CDLL(p) for p in ('a', 'b')]\n", 2),
    "script-in-def": ("import torch\n"
                      "def per_call(fn, x):\n"
                      "    return torch.jit.script(fn)(x)\n", 3),
    "graph-in-def": ("import torch\n"
                     "def capture(fn):\n"
                     "    g = torch.cuda.CUDAGraph()\n"
                     "    return g\n", 3),
    "trace-in-loop": ("import torch\n"
                      "for fn in ():\n"
                      "    torch.jit.trace(fn, ())\n", 3),
}

RETRACE_NEGATIVE = {
    "lru-cache": ("import functools\n"
                  "import torch\n"
                  "@functools.lru_cache(maxsize=8)\n"
                  "def factory(fn):\n"
                  "    return torch.compile(fn)\n"),
    "cache": ("import functools\n"
              "import torch\n"
              "@functools.cache\n"
              "def graphs(n):\n"
              "    return [torch.cuda.CUDAGraph() for _ in range(n)]\n"),
    "dict-cache": ("import ctypes\n"
                   "_LIBS: dict = {}\n"
                   "def library(name):\n"
                   "    lib = _LIBS.get(name)\n"
                   "    if lib is None:\n"
                   "        lib = _LIBS[name] = ctypes.CDLL(name)\n"
                   "    return lib\n"),
    "module-level": ("import ctypes\n"
                     "LIB = ctypes.CDLL('libc.so.6')\n"),
}


@pytest.mark.parametrize("case", sorted(RETRACE_POSITIVE))
def test_retrace_flags_per_call_builds(tmp_path, case):
    src, line = RETRACE_POSITIVE[case]
    _write(tmp_path, "src/repro_torch/core/mod.py", src)
    bad = _bad(_run(tmp_path), "retrace")
    assert [f.line for f in bad] == [line], case


@pytest.mark.parametrize("case", sorted(RETRACE_NEGATIVE))
def test_retrace_memoized_builds_are_clean(tmp_path, case):
    _write(tmp_path, "src/repro_torch/core/mod.py", RETRACE_NEGATIVE[case])
    assert _bad(_run(tmp_path), "retrace") == [], case


# -- f32-cast ---------------------------------------------------------------

F32_POSITIVE = {
    "to": "keys.to(torch.float32)",
    "to-device": "keys.to(dev, torch.float32)",
    "to-kw": "queries.to(dtype=torch.float32)",
    "float": "q_lo.float()",
    "as-tensor": "torch.as_tensor(keys, dtype=torch.float32)",
    "tensor": "torch.tensor(splits, dtype=torch.float32)",
    "astype": "keys.astype(np.float32)",
}

F32_NEGATIVE = {
    "mask": "(keys == q).float()",
    "non-key": "weights.to(torch.float32)",
    "f64": "keys.to(torch.float64)",
}


@pytest.mark.parametrize("case", sorted(F32_POSITIVE))
def test_f32_cast_flags_torch_spellings(tmp_path, case):
    _write(tmp_path, "src/repro_torch/core/mod.py",
           "import numpy as np\nimport torch\n\n"
           f"def shrink(keys, queries, q_lo, splits, dev):\n"
           f"    return {F32_POSITIVE[case]}\n")
    bad = _bad(_run(tmp_path), "f32-cast")
    assert [f.line for f in bad] == [5], case


@pytest.mark.parametrize("case", sorted(F32_NEGATIVE))
def test_f32_cast_spares_masks_and_other_values(tmp_path, case):
    _write(tmp_path, "src/repro_torch/core/mod.py",
           "import torch\n\n"
           f"def shrink(keys, q, weights):\n"
           f"    return {F32_NEGATIVE[case]}\n")
    assert _bad(_run(tmp_path), "f32-cast") == [], case


def test_f32_cast_gate_and_kernel_boundary_are_clean(tmp_path):
    _write(tmp_path, "src/repro_torch/core/mod.py", """\
        import torch

        class Index:
            def find(self, keys, path):
                if self._use_kernel(path):      # the port's gate
                    return keys.to(torch.float32)
                return keys

        def checked(keys):
            kf = keys.to(torch.float32)
            return kf, _f32_exact(keys, kf)
        """)
    _write(tmp_path, "src/repro_torch/kernels/mod.py", """\
        def pack(keys):
            return keys.float()
        """)
    assert _bad(_run(tmp_path), "f32-cast") == []


# -- kernel (.cu) -----------------------------------------------------------

_CU_HEAD = """\
#include <cuda_runtime.h>
namespace {
constexpr int kThreads = 128;
constexpr int kBig = 16384;       // floats: 64 KiB
struct Pair { int n; long long s; };
"""


def _cu(tmp, name, body, build_flags='"-O3", "-fmad=false"'):
    _write(tmp, f"src/repro_torch/kernels/csrc/{name}", _CU_HEAD + body)
    _write(tmp, "src/repro_torch/kernels/build.py",
           f"NVCC_FLAGS = ({build_flags})\n")


CU_POSITIVE = {
    "static-smem": ("lookup.cu", """\
__global__ void k(float* o) {
  __shared__ float buf[kBig];
  o[0] = buf[0];
}
}  // namespace
""", "static __shared__"),
    "dynamic-no-attribute": ("hist.cu", """\
__global__ void k(float* o) { extern __shared__ float s[]; o[0] = s[0]; }
}  // namespace
extern "C" int go(float* o, void* st) {
  constexpr int bytes = 4 * kBig;
  k<<<1, kThreads, bytes, static_cast<cudaStream_t>(st)>>>(o);
  return 0;
}
""", "no cudaFuncSetAttribute"),
    "over-budget": ("flash.cu", """\
__global__ void k(float* o) { extern __shared__ float s[]; o[0] = s[0]; }
}  // namespace
extern "C" int go(float* o, void* st) {
  cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       300000);
  k<<<1, kThreads, 300000, static_cast<cudaStream_t>(st)>>>(o);
  return 0;
}
""", "above the budget"),
    "attribute-in-another-launcher": ("ksdist.cu", """\
__global__ void k(float* o) { extern __shared__ float s[]; o[0] = s[0]; }
}  // namespace
extern "C" int set(void) {
  return cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              4 * kBig);
}
extern "C" int go(float* o, void* st) {
  k<<<1, kThreads, 4 * kBig, static_cast<cudaStream_t>(st)>>>(o);
  return 0;
}
""", "no cudaFuncSetAttribute"),
    "fma-in-lookup": ("lookup.cu", """\
__global__ void k(float* o) { o[0] = __fmaf_rn(o[1], o[2], o[3]); }
}  // namespace
""", "explicit FMA"),
    "double-in-lookup": ("lookup.cu", """\
__global__ void k(float* o) { double d = o[1]; o[0] = d; }
}  // namespace
""", "double in lookup.cu"),
    "fmad-flag": ("lookup.cu", """\
__global__ void k(float* o) { o[0] = o[1]; }
}  // namespace
""", "-fmad=false"),
}

CU_NEGATIVE = {
    "small-static": ("lookup.cu", """\
__global__ void k(float* o) {
  __shared__ int a[kThreads], b[kThreads];
  __shared__ Pair p[kThreads];
  o[0] = a[0] + b[0] + p[0].n;
}
}  // namespace
"""),
    "dynamic-with-attribute": ("ksdist.cu", """\
constexpr int kSmem = 96 * 1024;
template <int D>
__global__ void k(float* o) { extern __shared__ float s[]; o[0] = s[D]; }
template <int D>
int launch(float* o, cudaStream_t st) {
  auto kern = k<D>;
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       kSmem);
  kern<<<1, kThreads, kSmem, st>>>(o);
  return 0;
}
}  // namespace
extern "C" int go(float* o, void* st) {
  return launch<128>(o, static_cast<cudaStream_t>(st));
}
"""),
    "dynamic-runtime-bytes": ("hist.cu", """\
__global__ void k(float* o) { extern __shared__ float s[]; o[0] = s[0]; }
}  // namespace
extern "C" int go(float* o, int m, void* st) {
  k<<<1, kThreads, sizeof(float) * m * kBig, static_cast<cudaStream_t>(st)>>>(o);
  return 0;
}
"""),
    "fma-in-flash-and-comments": ("flash.cu", """\
// fmaf(a, b, c) in a comment; double in a comment
__global__ void k(float* o) {
  o[0] = fmaxf(__fmaf_rn(o[1], o[2], o[3]), o[4]);
}
}  // namespace
"""),
}


@pytest.mark.parametrize("case", sorted(CU_POSITIVE))
def test_kernel_rule_flags_cuda_fixtures(tmp_path, case):
    name, body, msg = CU_POSITIVE[case]
    flags = '"-O3"' if case == "fmad-flag" else '"-O3", "-fmad=false"'
    _cu(tmp_path, name, body, flags)
    bad = _bad(_run(tmp_path), "kernel")
    assert len(bad) == 1 and msg in bad[0].message, bad


@pytest.mark.parametrize("case", sorted(CU_NEGATIVE))
def test_kernel_rule_clean_cuda_fixtures(tmp_path, case):
    name, body = CU_NEGATIVE[case]
    _cu(tmp_path, name, body)
    assert _bad(_run(tmp_path), "kernel") == []


def test_kernel_figures_from_constants(tmp_path):
    """Sizes from constexpr, #define and enum constants and sizeof of a
    base type; a struct's size or a template parameter leaves a lower
    bound (not exact), a runtime argument an unbounded launch."""
    _cu(tmp_path, "ksdist.cu", """\
#define kRows (kThreads / 32)
enum { kA = 3, kB, kC = kB * 2 };
template <int N>
__global__ void __launch_bounds__(kThreads, 2) bounded(float* o) {
  __shared__ char flag[kA];
  __shared__ double d[kRows], e[kC];
  __shared__ unsigned int u[sizeof(float2) << 1];
  o[0] = flag[0] + d[0] + e[0] + u[0];
}
template <int N>
__global__ void partial(float* o) {
  __shared__ int a[kRows];
  __shared__ Pair p[4];
  __shared__ float t[N];
  o[0] = a[0] + p[0].s + t[0];
}
}  // namespace
extern "C" int go(float* o, int m, void* st) {
  cudaStream_t s = static_cast<cudaStream_t>(st);
  bounded<8><<<1, kThreads, 0, s>>>(o);
  partial<8><<<1, kThreads, sizeof(float) * m, s>>>(o);
  partial<8><<<1, kThreads, 4 * kBig, s>>>(o);
  return 0;
}
""")
    project = teng.load_project([tmp_path / "src"], root=tmp_path)
    kernels, launches = tkernel.figures(project.cuda[0])
    got = {k.kernel: (k.bytes, k.exact) for k in kernels}
    # char[3], then 8-aligned double[4] + double[8], then unsigned[16]
    assert got == {"bounded": (8 + 32 + 64 + 64, True),
                   "partial": (16, False)}
    assert [(la.kernel, la.static, la.dynamic) for la in launches] == [
        ("bounded", 168, 0), ("partial", 16, None),
        ("partial", 16, 4 * 16384)]
    assert _bad(_run(tmp_path), "kernel")[0].line == launches[2].line


def test_real_cuda_sources_figures():
    """The figures phase 13 of chip_smoke.py holds against the built
    libraries: static shared memory in two kernels only, K8's prefill
    barriers exact and K5's lower bound (its ``Run`` structs are not
    sized); every launch the constants bound is within the budget."""
    project = teng.load_project([REPO / "src/repro_torch/kernels/csrc"],
                                root=REPO)
    static, launches = {}, []
    for f in project.cuda:
        ks, ls = tkernel.figures(f)
        launches += ls
        static.update({k.kernel: (k.bytes, k.exact) for k in ks})
    assert static.pop("flash_tc_kernel") == (48, True)
    assert static.pop("linfit_kernel") == (3 * 8 * 4, False)
    assert set(static.values()) == {(0, True)}
    cfg = Config()
    assert all(la.static + la.dynamic <= cfg.smem_budget_bytes
               for la in launches if la.dynamic is not None)
    # the launchers that size dynamic memory at run time set the attribute
    assert {la.kernel for la in launches if la.has_attribute} == {
        "flash_cc_kernel", "flash_tc_kernel", "flash_split_kernel",
        "flash_bias_kernel", "ksdist_tables_staged_kernel", "ksdist_kernel"}


# -- chip_smoke.py's phase 13 helpers, on the CPU ----------------------------

def _chip_smoke():
    path = REPO / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# entries as ptxas and cuobjdump name them (nvcc's anonymous namespace)
_LINFIT = "_ZN41_GLOBAL__N__0a1b2c3d_9_linfit_cu_89abcdef13linfit_kernelEPKfS1_PKixiiiPd"
_FINISH = "_ZN41_GLOBAL__N__0a1b2c3d_9_linfit_cu_89abcdef20linfit_finish_kernelEPKdiPf"
_PTXAS = f"""\
ptxas info    : Compiling entry function '{_LINFIT}' for 'sm_90a'
ptxas info    : Function properties for {_LINFIT}
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 88 registers, used 1 barriers, 416 bytes smem
ptxas info    : Compiling entry function '{_FINISH}' for 'sm_90a'
ptxas info    : Used 8 registers
"""
_ELF = f"""\
Fatbin elf code:
================
arch = sm_90a
code version = [1,8]
host = linux
compile_size = 64bit

Sections:
Index Offset   Size ES Align                      Type    Flags Link     Info Name
    1     40    2fd  0  1                       STRTAB        0    0        0 .shstrtab
    9    f88      0 18  8                         RELA       40    3        c .rela.text.{_LINFIT}
    b    b00    480  0 80                     PROGBITS   100006    3        6 .text.{_FINISH}
    c   1200   6c00  0 80                     PROGBITS   100006    3        5 .text.{_LINFIT}
    d   7e00      0  0  1                       NOBITS        3    0        0 .nv.shared.reserved.0
    e   7e00    5a0  0  8                       NOBITS       43    0        c .nv.shared.{_LINFIT}

Symbols:
 0x7               0               0      0x3        0    0xe     .nv.shared.{_LINFIT}
"""


def test_chip_smoke_holds_the_kernel_rule_against_the_library():
    cs = _chip_smoke()
    assert cs._entry_name(
        "_ZN40_GLOBAL__N__d12099d2_8_flash_cu_e234ab5415flash_cc_kernelI13"
        "__nv_bfloat16Li16ELi1EEEvPKT_S4_S4_PS2_iiiiiiif") == "flash_cc_kernel"
    assert cs._entry_name("_Z11hist_kernelPKfxiffPy") == "hist_kernel"
    usage = cs._elf_smem(_ELF, 1024)
    assert cs._elf_smem(_ELF.replace(".nv.shared.reserved.0", ".bss"),
                        1024)[_LINFIT] == 0x5a0
    assert usage == cs._ptxas_smem(_PTXAS) == {_LINFIT: 416, _FINISH: 0}
    rows = cs._smem_vs_card({"linfit": usage})
    assert sorted((k, got, fig, exact) for _, k, got, fig, exact in rows) \
        == [("linfit_finish_kernel", 0, 0, True),
            ("linfit_kernel", 416, 96, False)]
    with pytest.raises(AssertionError, match="against the library's 64"):
        cs._smem_vs_card({"linfit": {_LINFIT: 64, _FINISH: 0}})
    with pytest.raises(AssertionError, match="no entry in the library"):
        cs._smem_vs_card({"linfit": {_LINFIT: 416}})
    helper = {**usage, "__internal_0_$__cuda_sm3x_div_rn_noftz_f32": 0}
    assert [r[1] for r in cs._smem_vs_card({"linfit": helper})].count(
        None) == 1


def test_chip_smoke_census_takes_only_flagged_sites(monkeypatch):
    """The census with the CUDA calls stubbed and ``.item()`` warning as
    the runtime's sync detector does: a read at a flagged site of the port
    is counted there; one the rule does not flag fails."""
    import types
    import warnings

    import torch

    from repro_torch.kernels import ops
    cs = _chip_smoke()
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode",
                        lambda *a, **k: None)
    item = torch.Tensor.item

    def warned(self):
        warnings.warn(cs.SYNC_WARNING)
        return item(self)
    monkeypatch.setattr(torch.Tensor, "item", warned)
    h = types.SimpleNamespace(uncounted=lambda fn: fn(), census={})
    t = torch.arange(5)
    cs._census(h, "cpu", {"one read": lambda: ops._reads([t.sum()])})
    (site, n), = h.census["cpu"]["one read"].items()
    assert site[0] == "src/repro_torch/kernels/ops.py" and n == 1
    assert "item()" in (REPO / site[0]).read_text().splitlines()[site[1] - 1]
    with pytest.raises(AssertionError, match="does not flag"):
        cs._census(h, "cpu", {"a read here": lambda: t.sum().item()})


# -- pragma grammar ---------------------------------------------------------

def test_pragma_grammar_in_python_comments(tmp_path):
    _write(tmp_path, "src/repro_torch/core/mod.py", """\
        x = 1  # tracelint: ok[hot-sync]()
        y = 2  # tracelint: ok[no-such-rule](whatever)
        z = 3  # tracelint: ok
        w = 4  # sync: ok()
        v = 5  # tracelint: ok[donation](not a port rule)
        """)
    by_line = {f.line: f.message for f in _bad(_run(tmp_path), "pragma")}
    assert "no reason" in by_line[1]
    assert "unknown rule id" in by_line[2]
    assert "malformed pragma" in by_line[3]
    assert "no reason" in by_line[4]
    assert "unknown rule id 'donation'" in by_line[5]


def test_pragma_grammar_in_cuda_comments(tmp_path):
    _cu(tmp_path, "lookup.cu", """\
__global__ void k(float* o) {
  // tracelint: ok[kernel]()
  o[0] = 1.0f;  // tracelint: ok[nope](whatever)
  o[1] = 2.0f;  // tracelint: ok
  const char* s = "// tracelint: ok[kernel](in a string)";
  double d = 0;  // tracelint: ok[kernel](a fixture's deliberate double)
}
}  // namespace
""")
    findings = _run(tmp_path)
    bad = {(f.line, f.rule): f.message for f in _bad(findings)}
    base = _CU_HEAD.count("\n")
    assert "no reason" in bad[(base + 2, "pragma")]
    assert "unknown rule id" in bad[(base + 3, "pragma")]
    assert "malformed pragma" in bad[(base + 4, "pragma")]
    assert not any(r == "kernel" for _, r in bad)      # the double
    assert [f.suppressed for f in findings if f.rule == "kernel"] == [
        "a fixture's deliberate double"]
    assert not any(line == base + 5 for line, _ in bad)  # in a string


def test_pragma_in_string_does_not_suppress(tmp_path):
    _write(tmp_path, "src/repro_torch/serve/frontend.py", """\
        class BatchingFrontend:
            def _dispatch(self, batch):
                label = "sync: ok(not a comment)"
                return batch.found.cpu(), label
        """)
    assert len(_bad(_run(tmp_path), "hot-sync")) == 1


# -- parity with the reference ----------------------------------------------

_PARITY_SRC = """\
    import jax.numpy as jnp
    import numpy as np

    from . import helpers as hp
    from .helpers import shared


    class Pack:
        def __init__(self, n):
            self.store = Store(n)

        def find(self, q):
            # sync: ok(the one read)
            out = np.asarray(self.store.get(q))
            hp.touch(out)
            return shared(out), self._inner(q)

        def _inner(self, q):
            def nested(z):
                return z.lookup_keys(z)      # name fallback
            return nested(q)


    class Store:
        def __init__(self, n):
            self.n = n

        def get(self, q):
            return jnp.asarray(q, dtype=jnp.float32)   # key cast
    """

_PARITY_HELPERS = """\
    import numpy as np


    def touch(x):
        return np.array(x)  # tracelint: ok[hot-sync](mirror)


    def shared(keys):
        kf = keys.astype(np.float32)
        return np.float32(keys), kf, np.asarray(keys, dtype="float32")


    def lookup_keys(z):
        return z  # tracelint: ok[f32-cast]()


    def cold(keys):
        return keys.astype("float32")   # tracelint: ok
    """


def _parity_tree(tmp):
    _write(tmp, "src/pkg/serve.py", _PARITY_SRC)
    _write(tmp, "src/pkg/helpers.py", _PARITY_HELPERS)
    return ("pkg.serve:Pack.find",)


def test_parity_scan_pragmas():
    from repro.analysis import engine as ref_eng
    for src in (_PARITY_SRC, _PARITY_HELPERS,
                (REPO / "src/repro_torch/serve/frontend.py").read_text(),
                (REPO / "src/repro/serve/frontend.py").read_text()):
        src = textwrap.dedent(src)
        assert teng._scan_pragmas(src) == ref_eng._scan_pragmas(src)


def test_parity_callgraph_reachability(tmp_path):
    from repro.analysis import Config as RefConfig
    from repro.analysis import engine as ref_eng
    roots = _parity_tree(tmp_path)
    ref = ref_eng.load_project([tmp_path / "src"], RefConfig(hot_roots=roots),
                               root=tmp_path).callgraph
    port = teng.load_project([tmp_path / "src"], Config(hot_roots=roots),
                             root=tmp_path).callgraph
    assert set(port.funcs) == set(ref.funcs)
    assert {q: fi.calls for q, fi in port.funcs.items()} == \
        {q: fi.calls for q, fi in ref.funcs.items()}
    got = port.reachable(roots)
    assert got == ref.reachable(roots)
    assert "pkg.helpers:lookup_keys" in got      # through the fallback


def test_parity_f32_cast_numpy_spellings(tmp_path):
    from repro.analysis import analyze as ref_analyze
    _parity_tree(tmp_path)
    key = lambda fs: sorted((str(f.path), f.line, f.suppressed)
                            for f in fs if f.rule == "f32-cast")
    ref = ref_analyze([tmp_path / "src"], root=tmp_path)
    port = _run(tmp_path)
    assert key(port) == key(ref)
    assert len(key(port)) == 5
    # and the pragma errors of the fixture are the same
    perr = lambda fs: sorted((str(f.path), f.line, f.message)
                             for f in fs if f.rule == "pragma")
    assert perr(port) == perr(ref) and len(perr(port)) == 2


# -- the real tree ----------------------------------------------------------

def test_seeded_violations_in_real_frontend_and_ops_fail(tmp_path):
    shutil.copytree(REPO / "src/repro_torch", tmp_path / "src/repro_torch",
                    ignore=shutil.ignore_patterns("__pycache__", "csrc"))
    strip = re.compile(r"#\s*(sync:\s*ok\([^)]*\)|tracelint:\s*ok\[hot-sync\]"
                       r"\([^)]*\))")
    for rel in ("serve/frontend.py", "kernels/ops.py"):
        p = tmp_path / "src/repro_torch" / rel
        real = p.read_text()
        seeded = strip.sub("# (pragma stripped)", real)
        assert seeded != real, f"fixture drift: {rel} lost its pragmas"
        p.write_text(seeded)
    bad = _bad(_run(tmp_path), "hot-sync")
    where = {(Path(f.path).name, f.message.split()[-1]) for f in bad}
    assert ("frontend.py", "BatchingFrontend._resolve") in where
    assert ("ops.py", "_reads") in where
    assert ("ops.py", "_nonzeros") in where
    assert {Path(f.path).name for f in bad} == {"frontend.py", "ops.py"}


def test_real_port_tree_is_clean():
    findings = analyze([REPO / p for p in PORT_PATHS], root=REPO)
    assert _bad(findings) == []
    assert all(f.suppressed for f in findings if f.suppressed is not None)
    hot = {(str(f.path), f.line) for f in findings if f.rule == "hot-sync"}
    for site in (("src/repro_torch/kernels/ops.py", "_reads"),
                 ("src/repro_torch/core/distributed.py", "_exchange"),
                 ("src/repro_torch/serve/frontend.py", "_resolve")):
        assert any(p == site[0] for p, _ in hot), site
    assert not any(Path(str(f.path)).suffix == ".cu" for f in findings)


def test_analysis_imports_neither_jax_nor_repro():
    for path in (REPO / "src/repro_torch/analysis").rglob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                assert top not in {"jax", "jaxlib", "repro"}, (path, name)


# -- CLI --------------------------------------------------------------------

def test_cli_exit_codes_list_rules_and_smem_budget(tmp_path, capsys,
                                                   monkeypatch):
    monkeypatch.chdir(tmp_path)
    _write(tmp_path, "src/repro_torch/serve/frontend.py",
           _hot(HOT_POSITIVE["item"]))
    assert cli_main(["src"]) == 1
    out = capsys.readouterr().out
    assert "[hot-sync]" in out and "tracelint:" in out

    clean = tmp_path / "clean"
    _write(clean, "src/repro_torch/core/mod.py", "X = 1\n")
    monkeypatch.chdir(clean)
    assert cli_main(["src"]) == 0

    assert cli_main(["--list-rules"]) == 0
    out = capsys.readouterr().out
    for rid in ("hot-sync", "retrace", "f32-cast", "kernel", "donation"):
        assert rid in out
    assert "not ported" in out

    # a 128 KiB launch fits the H100's budget, not a third of it
    big = tmp_path / "big"
    _cu(big, "ksdist.cu", CU_NEGATIVE["dynamic-with-attribute"][1].replace(
        "96 * 1024", "128 * 1024"))
    monkeypatch.chdir(big)
    assert cli_main(["-q", "src"]) == 0
    assert cli_main(["-q", "--smem-budget", "101376", "src"]) == 1
    out = capsys.readouterr().out
    assert "ksdist.cu" in out and "above the budget 101376" in out
