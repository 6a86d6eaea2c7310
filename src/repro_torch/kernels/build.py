"""Build and bind the port's CUDA kernels.

Every ``csrc/*.cu`` source is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, at first use, into ``build/`` at
the root of the checkout (listed in ``.gitignore``).  Each library's file
name carries a hash of its source and flags, so an edited source is never
served by a stale build.  The libraries are loaded with ``ctypes``.
Sources are built in parallel, one ``nvcc`` process each.

Nothing here runs at import: the CPU tests import every module, and this
machine may have neither ``nvcc`` nor a card.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
LL = ctypes.c_longlong
# argtypes of every C entry point, by library
SIGNATURES = {
    "lookup": {
        "repro_lookup": (P, I, P, P, P, I, I, F, P, I, F, F, I, I, I, P, P,
                         P, P),
        "repro_dynamic_lookup": (P, I, P, P, P, I, I, F, P, I, F, F, I,
                                 I, I, P, P, I, I, P, P, P),
        "repro_dynamic_range": (P, P, I, P, P, P, I, I, F, P, I, F, F, I,
                                I, I, P, I, I, P, P, P, P, P),
        "repro_rmrt_lookup": (P, I, P, P, I, P, P, I, I, I, P, I, F, F, I,
                              P, P),
        "repro_shard_tables_size": (),
        "repro_set_shard_tables": (P, I, P, P, P, I, I, F, P, I, F, F, I,
                                   P, P, P, I, I),
        "repro_sharded_lookup": (P, P, I, P, I, I, I, P, P),
        "repro_sharded_dynamic_lookup": (P, P, I, P, I, I, I, P, P, P),
        "repro_sharded_dynamic_range": (P, P, P, I, P, I, I, I, P, P, P, P,
                                        P),
    },
    "ksdist": {
        "repro_ksdist_tables": (P, I, I, I, P, P, P),
        "repro_ksdist": (P, P, I, P, P, I, I, P, P),
    },
    "hist": {
        "repro_hist": (P, LL, I, F, F, F, I, P, P, P),
    },
    "linfit": {
        "repro_linfit_sums": (P, P, P, LL, I, P, P, P),
    },
    "flash": {
        "repro_flash_cc": (P, P, P, P, P, P, I, I, I, I, I, I, I, I, I, I,
                           I, F, P),
        "repro_flash_tc": (P, P, P, P, P, P, I, I, I, I, I, I, I, I, I, F,
                           P),
        "repro_flash_decode": (P, P, P, P, P, P, P, P, P, I, I, I, I, I, I,
                               I, I, I, F, I, I, P),
        "repro_flash_bias": (P, P, P, P, P, P, P, I, I, I, I, I, I, I, I, F,
                             P),
        "repro_flash_merge": (P, P, P, P, I, I, I, I, I, P),
    },
}

_LIBS: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built at "
                           "first use on a machine with the CUDA toolkit")
    return found


def _target(name: str, src: Path | None = None) -> Path:
    src = CSRC / f"{name}.cu" if src is None else Path(src)
    tag = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()
                         ).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{tag}.so"


def _start(src: Path, nvcc: str):
    """Start one nvcc build of ``src`` into a temporary file in BUILD_DIR."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    proc = subprocess.Popen(
        [nvcc, *NVCC_FLAGS, "-o", tmp, str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp


def _finish(jobs: dict) -> dict[str, str]:
    """Wait for ``{key: ((proc, tmp), target)}``; move each build to its
    target; raise if any failed.  Returns nvcc's output per key."""
    failed, reports = [], {}
    for key, ((proc, tmp), target) in jobs.items():
        out, _ = proc.communicate()
        reports[key] = out
        if proc.returncode != 0:
            failed.append(f"{key}:\n{out}")
            Path(tmp).unlink(missing_ok=True)
        else:
            os.replace(tmp, target)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return reports


def build_all(names=tuple(SIGNATURES)) -> dict[str, str]:
    """Build every named library that is not built yet, all nvcc processes
    started together.  Returns what nvcc printed (the ``-Xptxas -v``
    report: registers, shared memory, spills) per library built now."""
    todo = [n for n in names if not _target(n).exists()]
    if not todo:
        return {}
    nvcc = _nvcc()
    return _finish({n: (_start(CSRC / f"{n}.cu", nvcc), _target(n))
                    for n in todo})


def build_sources(name: str, sources: dict) -> dict:
    """Build other sources of library ``name`` side by side, for
    measurements (an earlier design, say): ``{key: path}`` -> ``{key:
    (library, nvcc's report)}``, each bound with ``name``'s signatures, so
    each source must have ``name``'s C interface."""
    nvcc = _nvcc()
    reports = _finish({key: (_start(Path(src), nvcc), _target(name, src))
                       for key, src in sources.items()})
    # tracelint: ok[retrace](a measurement helper: each source loaded once)
    return {key: (_bind(ctypes.CDLL(str(_target(name, src))), name),
                  reports[key]) for key, src in sources.items()}


def _cuobjdump(name: str, flag: str) -> str:
    build_all((name,))
    cuobjdump = Path(_nvcc()).parent / "cuobjdump"
    return subprocess.run([str(cuobjdump), flag, str(_target(name))],
                          capture_output=True, text=True, check=True).stdout


def sass(name: str) -> str:
    """``cuobjdump -sass`` of the built library ``name`` (built first if
    needed): the instructions the card runs."""
    return _cuobjdump(name, "-sass")


def elf(name: str) -> str:
    """``cuobjdump -elf`` of the built library ``name`` (built first if
    needed): its cubin's sections, each function's code and static shared
    memory among them, whether or not this process built it."""
    return _cuobjdump(name, "-elf")


def library(name: str) -> ctypes.CDLL:
    """The loaded library ``name`` (built first if needed), with argtypes
    and restype set on every entry point."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all((name,))
        lib = _LIBS[name] = _bind(ctypes.CDLL(str(_target(name))), name)
    return lib


def _bind(lib: ctypes.CDLL, name: str) -> ctypes.CDLL:
    """Set argtypes and restype on every entry point of library ``name``."""
    for fn, argtypes in SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.argtypes = list(argtypes)
        f.restype = ctypes.c_int
    return lib


def check(rc: int, what: str) -> None:
    """Raise when a launch returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {rc}")
