"""Run a reference test file's cases a second time, against the port.

:func:`port_of` reads ``tests/<name>``, points every import of the JAX
package (``mosaic_tpu``) at the port (``mosaic_tpu_torch``) and executes
the result as a module of its own. A port test file then takes the cases
it wants with :func:`cases`: pytest collects each of the reference's tests,
with its parameters, marks and fixtures, against the port. A reference
test that reaches the reference's ``jax.numpy`` lane is left out by name
and written again in the port's file against the port's torch lane.

The port's entry points run on the card unless the caller passes
``device="cpu"``. The reference's tests call the function surface without
a device, so ``from mosaic_tpu import functions as F`` becomes
:data:`CPU_FUNCTIONS`, the port's surface with ``device="cpu"`` filled in
wherever a function takes one.
"""

from __future__ import annotations

import functools
import inspect
import re
import types
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent


class _CPUFunctions:
    def __getattr__(self, name):
        from mosaic_tpu_torch import functions

        fn = getattr(functions, name)
        if callable(fn) and "device" in inspect.signature(fn).parameters:
            return functools.partial(fn, device="cpu")
        return fn


#: the port's function surface, on the CPU
CPU_FUNCTIONS = _CPUFunctions()


def port_of(name: str) -> types.ModuleType:
    """The reference's test module ``tests/<name>``, importing the port."""
    src = (HERE / name).read_text()
    src = src.replace(
        "from mosaic_tpu import functions as F",
        "from torch_reference_tests import CPU_FUNCTIONS as F",
    )
    src = re.sub(r"\bmosaic_tpu\b(?!_torch)", "mosaic_tpu_torch", src)
    mod = types.ModuleType(f"port_of_{Path(name).stem}")
    mod.__file__ = str(HERE / name)
    exec(compile(src, str(HERE / name), "exec"), mod.__dict__)
    return mod


def cases(mod: types.ModuleType, skip=()) -> dict:
    """The test functions and test classes of ``mod``, less the names in
    ``skip``, for a port test file's ``globals()``."""
    return {k: v for k, v in vars(mod).items()
            if k.startswith(("test_", "Test")) and k not in skip}


@pytest.fixture
def fresh_registries(monkeypatch):
    """Empty CRS registries in both packages for one test. Each package
    keeps its own, and a registration outlives the test that made it:
    reading a `.prj` registers its code (a shapefile written with
    ``srid=27700`` re-registers 27700 without the Helmert shift)."""
    from mosaic_tpu.core import crs as RC, crs_proj as RP, crs_wkt as RW
    from mosaic_tpu_torch.core import crs as TC, crs_proj as TP, crs_wkt as TW

    for crs_mod, proj_mod, wkt_mod in ((RC, RP, RW), (TC, TP, TW)):
        monkeypatch.setattr(proj_mod, "_REGISTERED", {})
        monkeypatch.setattr(crs_mod, "_PROJ_BOUNDS_CACHE", {})
        monkeypatch.setattr(wkt_mod, "_synthetic", {})
