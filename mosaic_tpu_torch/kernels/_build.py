"""Build and bind the hand-written CUDA kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` into a shared library with a plain C
interface and loaded with ``ctypes`` — no PyTorch headers, so a build
takes seconds. Libraries go to ``kernels/.build/`` (ignored by git),
named by a hash of the source and flags, and are built on first use:
nothing is compiled when the package is imported.

Flags: ``sm_90a`` (Hopper), ``-fmad=false`` so that no multiply-add is
contracted, IEEE division and square root, no fast math — the kernels are
held bit for bit against their plain torch versions.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_HERE = Path(__file__).resolve().parent
SOURCES = {"pip": _HERE / "csrc" / "pip.cu"}
BUILD_DIR = _HERE / ".build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
    "-fmad=false", "-prec-div=true", "-prec-sqrt=true", "-ftz=false",
    "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_F = ctypes.c_float
#: C signature of every entry point, by library
SIGNATURES = {
    "pip": {
        # points, n, planes, E, G, n_real_g, out, stream
        "mosaic_pip_zone": (_P, _LL, _P, _I, _I, _I, _P, _P),
        # px, py, rows, K, edges, bits, geom, E2, M2, eps2, banded,
        # best, near, stream
        "mosaic_pip_heavy": (
            _P, _P, _P, _LL, _P, _P, _P, _I, _I, _F, _I, _P, _P, _P,
        ),
    },
}

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}
#: compiler output (ptxas register/shared-memory report) per library
BUILD_LOGS: dict[str, str] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    default = os.path.join(home, "bin", "nvcc")
    if os.path.exists(default):
        return default
    raise RuntimeError(
        "nvcc not found: the CUDA kernels are built from source on first "
        "use and need the CUDA toolkit (nvcc on PATH or under $CUDA_HOME)"
    )


def library_path(name: str) -> Path:
    src = SOURCES[name]
    key = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{key.hexdigest()[:16]}.so"


def compile_library(name: str) -> Path:
    """Run nvcc for one source unless its library is already built."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[name])]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    BUILD_LOGS[name] = proc.stdout + proc.stderr
    if proc.returncode:
        raise RuntimeError(
            f"nvcc failed for {SOURCES[name].name} (rc {proc.returncode}):\n"
            f"{' '.join(cmd)}\n{BUILD_LOGS[name]}"
        )
    os.replace(tmp, out)
    return out


def load(name: str) -> ctypes.CDLL:
    """The bound library ``name`` (built on first use)."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(compile_library(name)))
            for fn, argtypes in SIGNATURES[name].items():
                f = getattr(lib, fn)
                f.argtypes = list(argtypes)
                f.restype = ctypes.c_int
            _LIBS[name] = lib
        return lib


def check(rc: int, what: str) -> None:
    """Raise when a C entry point reports a CUDA error."""
    if rc:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {rc}")
