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
        "repro_lookup": (P, I, P, P, P, I, I, F, P, I, F, F, I, I, I, P, P),
        "repro_dynamic_lookup": (P, I, P, P, P, I, I, F, P, I, F, F, I,
                                 I, I, P, I, I, P, P, P),
        "repro_dynamic_range": (P, P, I, P, P, P, I, I, F, P, I, F, F, I,
                                I, I, P, I, I, P, P, P, P, P),
        "repro_rmrt_lookup": (P, I, P, P, I, I, I, I, P, I, F, F, I, P, P),
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
        "repro_flash_cc": (P, P, P, P, I, I, I, I, I, I, I, I, I, I, F, P),
        "repro_flash_tc": (P, P, P, P, I, I, I, I, I, I, I, I, F, P),
        "repro_flash_decode": (P, P, P, P, P, I, I, I, I, I, I, I, I, F, I,
                               I, P),
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


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{tag}.so"


def _start(name: str, nvcc: str):
    """Start one nvcc build into a temporary file beside the target."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    proc = subprocess.Popen(
        [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp


def build_all(names=tuple(SIGNATURES)) -> dict[str, str]:
    """Build every named library that is not built yet, all nvcc processes
    started together.  Returns what nvcc printed (the ``-Xptxas -v``
    report: registers, shared memory, spills) per library built now."""
    todo = [n for n in names if not _target(n).exists()]
    if not todo:
        return {}
    nvcc = _nvcc()
    jobs = {n: _start(n, nvcc) for n in todo}
    failed, reports = [], {}
    for n, (proc, tmp) in jobs.items():
        out, _ = proc.communicate()
        reports[n] = out
        if proc.returncode != 0:
            failed.append(f"{n}:\n{out}")
            Path(tmp).unlink(missing_ok=True)
        else:
            os.replace(tmp, _target(n))
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return reports


def sass(name: str) -> str:
    """``cuobjdump -sass`` of the built library ``name`` (built first if
    needed): the instructions the card runs."""
    build_all((name,))
    cuobjdump = Path(_nvcc()).parent / "cuobjdump"
    return subprocess.run([str(cuobjdump), "-sass", str(_target(name))],
                          capture_output=True, text=True, check=True).stdout


def library(name: str) -> ctypes.CDLL:
    """The loaded library ``name`` (built first if needed), with argtypes
    and restype set on every entry point."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all((name,))
        lib = ctypes.CDLL(str(_target(name)))
        for fn, argtypes in SIGNATURES[name].items():
            f = getattr(lib, fn)
            f.argtypes = list(argtypes)
            f.restype = ctypes.c_int
        _LIBS[name] = lib
    return lib


def check(rc: int, what: str) -> None:
    """Raise when a launch returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {rc}")
