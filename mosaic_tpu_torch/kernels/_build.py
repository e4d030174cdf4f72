"""Build and bind the hand-written CUDA kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` into a shared library with a plain C
interface and loaded with ``ctypes`` — no PyTorch headers, so a build
takes seconds. Libraries go to ``kernels/.build/`` (ignored by git),
named by a hash of the source and flags, and are built on first use:
nothing is compiled when the package is imported. :func:`load_all`
builds every missing library at once, one nvcc process per source. A
library may instead come from a program store (`dispatch/programs.py`):
:func:`bind_payload` writes the stored bytes to the library's path and
binds them before :func:`compile_libraries` would start nvcc, so a
machine without the CUDA toolkit launches the kernels it was given.

Flags: ``sm_90a`` (Hopper), ``-fmad=false`` so that no multiply-add is
contracted, IEEE division and square root, no fast math — the kernels are
held bit for bit against their plain torch versions.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import struct
import subprocess
import threading
from pathlib import Path

import torch

from ..runtime.errors import KernelCompileError, KernelLaunchError

_HERE = Path(__file__).resolve().parent
SOURCES = {
    "pip": _HERE / "csrc" / "pip.cu",
    "zonal": _HERE / "csrc" / "zonal.cu",
    "h3": _HERE / "csrc" / "h3.cu",
}
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
_D = ctypes.c_double
#: C signature of every entry point, by library
SIGNATURES = {
    "pip": {
        # points, n, planes, E, G, n_real_g, out, stream
        "mosaic_pip_zone": (_P, _LL, _P, _I, _I, _I, _P, _P),
        # px, py, rows, K, H, edges, bits, geom, E2, M2, eps2, banded,
        # best, near, scratch, scratch_ints, stream
        "mosaic_pip_heavy": (
            _P, _P, _P, _LL, _I, _P, _P, _P, _I, _I, _F, _I, _P, _P, _P,
            _LL, _P,
        ),
        # K, H -> int32 scratch entries mosaic_pip_heavy needs
        "mosaic_pip_heavy_scratch": (_LL, _I),
    },
    "zonal": {
        # vals, seg, n, S, tile_n, tile_s, scratch, cnt, sum, min, max,
        # stream
        "mosaic_zonal_tiled": (
            _P, _P, _LL, _I, _I, _I, _P, _P, _P, _P, _P, _P,
        ),
        # sorted_vals, ends, S, cnt, sum, min, max, stream
        "mosaic_zonal_seq_fold_f32": (_P, _P, _I, _P, _P, _P, _P, _P),
        "mosaic_zonal_seq_fold_f64": (_P, _P, _I, _P, _P, _P, _P, _P),
        # x, step, n, out, cycles, stream
        "mosaic_dadd_chain": (_D, _D, _I, _P, _P, _P),
    },
    "h3": {
        # xy, n, row stride, column stride, face vec3, face basis, combo,
        # turns, rotation powers, scalars (8 doubles), pack constant, res,
        # cells, margins (or null), stream
        "mosaic_h3_cells_f32": (
            _P, _LL, _LL, _LL, _P, _P, _P, _P, _P, _P, _LL, _I, _P, _P, _P,
        ),
        "mosaic_h3_cells_f64": (
            _P, _LL, _LL, _LL, _P, _P, _P, _P, _P, _P, _LL, _I, _P, _P, _P,
        ),
    },
}

#: return types other than the CUDA error code (int)
RESTYPES = {"mosaic_pip_heavy_scratch": _LL}

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}
#: nvcc jobs this process started (`nvcc_builds`); a library already on
#: disk under BUILD_DIR (same source, same flags) starts none
_NVCC_JOBS = 0
#: compiler output (ptxas register/shared-memory report) per library
BUILD_LOGS: dict[str, str] = {}
#: where each bound library came from: "nvcc" (built by this process),
#: "disk" (built before, found under BUILD_DIR) or "store" (`bind_payload`)
ORIGINS: dict[str, str] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    default = os.path.join(home, "bin", "nvcc")
    if os.path.exists(default):
        return default
    raise KernelCompileError(
        "nvcc not found: the CUDA kernels are built from source on first "
        "use and need the CUDA toolkit (nvcc on PATH or under $CUDA_HOME)"
    )


def source_hash(name: str) -> str:
    """The hash of library ``name``'s source and the nvcc flags: its
    build's identity (the library's file name, a store entry's key)."""
    src = SOURCES[name]
    key = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return key.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}_{source_hash(name)}.so"


def nvcc_builds() -> int:
    """How many nvcc jobs this process has started: the port's only
    compiler, so the dispatch core's ``backend_compiles`` reads this. A
    process whose libraries are already on disk reads 0."""
    return _NVCC_JOBS


def loaded_libraries() -> list[str]:
    """Names of the kernel libraries bound in this process."""
    return sorted(_LIBS)


def compile_libraries(names) -> None:
    """Build every library in ``names`` that is not built yet: one nvcc
    per source, all started together, then waited for."""
    global _NVCC_JOBS
    jobs = []
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[name])]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True
        )
        _NVCC_JOBS += 1
        jobs.append((name, out, tmp, cmd, proc))
    failed = []
    for name, out, tmp, cmd, proc in jobs:
        stdout, stderr = proc.communicate()
        BUILD_LOGS[name] = stdout + stderr
        if proc.returncode:
            failed.append(
                f"nvcc failed for {SOURCES[name].name} (rc {proc.returncode}):\n"
                f"{' '.join(cmd)}\n{BUILD_LOGS[name]}"
            )
        else:
            os.replace(tmp, out)
    if failed:
        raise KernelCompileError("\n".join(failed))


def _bind(name: str, origin: str | None = None) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(library_path(name)))
    for fn, argtypes in SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.argtypes = list(argtypes)
        f.restype = RESTYPES.get(fn, ctypes.c_int)
    _LIBS[name] = lib
    ORIGINS[name] = origin or ("nvcc" if name in BUILD_LOGS else "disk")
    return lib


def load(name: str) -> ctypes.CDLL:
    """The bound library ``name`` (built on first use)."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            compile_libraries([name])
            lib = _bind(name)
        return lib


def load_all(names=None) -> dict[str, ctypes.CDLL]:
    """The libraries ``names`` (every library by default), bound; the
    missing ones are built in parallel. Returns every bound library."""
    with _LOCK:
        missing = [n for n in (SOURCES if names is None else names) if n not in _LIBS]
        compile_libraries(missing)
        for name in missing:
            _bind(name)
        return dict(_LIBS)


def library_bytes(name: str) -> bytes:
    """The bytes of the built library ``name`` (what a store keeps)."""
    return library_path(name).read_bytes()


def check_shared_object(payload: bytes) -> None:
    """Raise ``ValueError`` unless ``payload`` is a whole ELF64 shared
    object: its header, program and section header tables, and every
    loadable segment lie inside it. ``dlopen`` maps a truncated library's
    segments past the end of the file, and the first read there kills the
    process with SIGBUS instead of failing."""
    if len(payload) < 64 or payload[:5] != b"\x7fELF\x02":
        raise ValueError("not an ELF64 object")
    end = "<" if payload[5] == 1 else ">"
    e_type, = struct.unpack_from(end + "H", payload, 16)
    phoff, shoff = struct.unpack_from(end + "QQ", payload, 32)
    phentsize, phnum, shentsize, shnum = struct.unpack_from(end + "HHHH", payload, 54)
    if e_type != 3:  # ET_DYN
        raise ValueError(f"ELF type {e_type} is not a shared object")
    if phoff + phnum * phentsize > len(payload) or shoff + shnum * shentsize > len(payload):
        raise ValueError("truncated: a header table lies past the end")
    for i in range(phnum):
        p_type, = struct.unpack_from(end + "I", payload, phoff + i * phentsize)
        offset, = struct.unpack_from(end + "Q", payload, phoff + i * phentsize + 8)
        filesz, = struct.unpack_from(end + "Q", payload, phoff + i * phentsize + 32)
        if p_type == 1 and offset + filesz > len(payload):  # PT_LOAD
            raise ValueError("truncated: a loadable segment lies past the end")


def bind_payload(name: str, payload: bytes) -> ctypes.CDLL:
    """Bind library ``name`` from ``payload``, the bytes of a build of
    the same source and flags, and start no nvcc job: the payload is
    written to the library's path (temp file, then ``os.replace``) and
    loaded there. A library this process has bound already stays bound;
    ``payload`` must then be the bound file's bytes. Raises ``ValueError``
    when the payload is not a whole shared object
    (:func:`check_shared_object`) or not the bound build, ``OSError`` when
    it does not load, and ``AttributeError`` when it lacks an entry point
    of ``SIGNATURES[name]``."""
    check_shared_object(payload)
    with _LOCK:
        out = library_path(name)
        if name in _LIBS:
            if out.read_bytes() != payload:
                raise ValueError(
                    f"library {name!r} is bound from another build in this process"
                )
            return _LIBS[name]
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        tmp.write_bytes(payload)
        os.replace(tmp, out)
        try:
            return _bind(name, "store")
        except (OSError, AttributeError):
            _LIBS.pop(name, None)
            ORIGINS.pop(name, None)
            out.unlink(missing_ok=True)
            raise


def check(rc: int, what: str) -> None:
    """Raise when a C entry point reports a CUDA error."""
    if rc:
        raise KernelLaunchError(f"{what}: CUDA launch failed with cudaError {rc}")


#: per thread: the launches recorded under a CUDA graph capture
#: (`captured_launches`)
_CAPTURE = threading.local()


def count_launch(wrapper) -> None:
    """Count one launch of the kernel behind ``wrapper`` in its
    ``launches`` attribute. Under a CUDA graph capture nothing runs: the
    launch goes to the capture's record (`captured_launches`), and each
    replay of the graph counts it (`count_replay`)."""
    if torch.cuda.is_current_stream_capturing():
        record = getattr(_CAPTURE, "record", None)
        if record is not None:
            record[wrapper] = record.get(wrapper, 0) + 1
        return
    wrapper.launches += 1


class _Record(dict):
    """A capture's record: ``{wrapper: launches}``, and in ``actions`` the
    host-side counts to repeat at each replay (`on_each_run`)."""

    def __init__(self):
        super().__init__()
        self.actions: list = []


@contextlib.contextmanager
def captured_launches():
    """Record the kernel launches captured into a CUDA graph in this
    thread during the block; yields ``{wrapper: launches}``, which
    `count_replay` adds to the wrappers' counts at each replay."""
    outer = getattr(_CAPTURE, "record", None)
    record = _Record()
    _CAPTURE.record = record
    try:
        yield record
    finally:
        _CAPTURE.record = outer


def on_each_run(fn) -> None:
    """Call ``fn()`` for work just queued on the card: now, or, under a
    CUDA graph capture, at each replay of the graph instead (nothing ran
    at the capture). For host-side counts of what the card did; call it
    only for work on a CUDA tensor."""
    if torch.cuda.is_current_stream_capturing():
        record = getattr(_CAPTURE, "record", None)
        if record is not None:
            record.actions.append(fn)
        return
    fn()


def count_replay(record: dict) -> None:
    """Count the launches one replay of a captured graph makes, and
    repeat its recorded host-side counts."""
    for wrapper, n in record.items():
        wrapper.launches += n
    for fn in getattr(record, "actions", ()):
        fn()
