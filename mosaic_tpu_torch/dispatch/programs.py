"""What the port keeps in place of the reference's program store.

The reference's ``mosaic_tpu/dispatch/programs.py`` serializes XLA
executables (``ProgramStore``, ``program_key``) so that a relaunched
server loads its warmed ladder instead of compiling it: zero cold
compiles on relaunch. The port compiles no program per shape. Its only
compiler is ``nvcc``, which builds each kernel library once, into
``kernels/.build/`` under a hash of the source and the flags
(`kernels/_build.py`), so a relaunch on the same machine builds nothing.
What the port promises instead (ROADMAP queue 3, "Reference behaviour the
port does not carry over"):

- zero nvcc builds after the first process on a machine
  (`dispatch.backend_compiles` reads 0 new builds);
- zero new dispatch signatures after `DispatchCore.warmup` (the
  ``freeze()`` tripwire counts ``cold_compiles``);
- warmup runs each ladder rung once, to prime the caching allocator and
  bind the kernel library before traffic arrives.

``ProgramStore``, ``program_key`` and serialization are not ported. An
explicit ``program_store=`` or a set ``MOSAIC_PROGRAM_STORE`` raises
``NotImplementedError`` at the entry point (`DispatchCore`,
`ServeEngine`, `ServeRouter`) instead of being ignored.
"""

from __future__ import annotations

import os

_STORE_TODO = (
    "is not ported: the port has no compiled program to store — its "
    "only build is nvcc, cached on disk per machine (ROADMAP queue 3, "
    "'Reference behaviour the port does not carry over': the program "
    "store)"
)


def resolve_program_store(program_store=None) -> None:
    """``None`` when no store is asked for; raises ``NotImplementedError``
    for an explicit ``program_store`` or a set ``MOSAIC_PROGRAM_STORE``."""
    if program_store is not None:
        raise NotImplementedError(f"program_store={program_store!r} {_STORE_TODO}")
    env = os.environ.get("MOSAIC_PROGRAM_STORE", "").strip()
    if env:
        raise NotImplementedError(f"MOSAIC_PROGRAM_STORE={env!r} {_STORE_TODO}")
    return None
