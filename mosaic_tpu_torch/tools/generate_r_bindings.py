"""Generate the R binding package of the port from its registered
function surface.

Port of the reference's ``tools/generate_r_bindings.py``: walks
``MosaicContext.build("H3").register()`` + ``inspect.signature`` and emits
a reticulate-backed R package (``R/mosaicTpuTorch/``: ``R/functions.R``,
``DESCRIPTION``, ``NAMESPACE``) with one wrapper per registered name plus
``enableMosaic``, over ``mosaic_tpu_torch``. Regenerate after adding
functions:

    python -m mosaic_tpu_torch.tools.generate_r_bindings
"""

from __future__ import annotations

import inspect
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
OUT = REPO / "R" / "mosaicTpuTorch"

HEADER = '''# Generated by `python -m mosaic_tpu_torch.tools.generate_r_bindings` — do not edit.
# reticulate-backed R bindings over the mosaic_tpu_torch function registry
# (reference analog: R/sparkR-mosaic + R/sparklyr-mosaic, generated from
# the Scala DSL signatures by R/generate_R_bindings.R).

#' @import reticulate
.mosaic_env <- new.env(parent = emptyenv())

#' Enable mosaic_tpu_torch (builds the process context)
#' @param index_system "H3", "BNG" or "CUSTOM(...)"
#' @export
enableMosaic <- function(index_system = "H3") {
  mt <- reticulate::import("mosaic_tpu_torch")
  .mosaic_env$ctx <- mt$MosaicContext$build(index_system)
  .mosaic_env$fns <- .mosaic_env$ctx$register()
  invisible(.mosaic_env$ctx)
}

.mosaic_call <- function(name, ...) {
  if (is.null(.mosaic_env$fns)) enableMosaic()
  do.call(.mosaic_env$fns[[name]], list(...))
}
'''

DESCRIPTION = (
    "Package: mosaicTpuTorch\n"
    "Title: R bindings for the mosaic_tpu_torch geospatial framework\n"
    "Version: 0.1.0\n"
    "Description: Generated reticulate wrappers over the\n"
    "    mosaic_tpu_torch function registry (st_/grid_/rst_ names).\n"
    "Imports: reticulate\n"
    "License: Apache-2.0\n"
    "Encoding: UTF-8\n"
)

NAMESPACE = "exportPattern('^[^.]')\nimport(reticulate)\n"


def r_wrapper(name: str, sig: inspect.Signature) -> str:
    params = []
    passes = []
    var_used = False
    for p in sig.parameters.values():
        if p.kind in (p.VAR_POSITIONAL, p.VAR_KEYWORD):
            if not var_used:  # R allows exactly one `...` formal
                params.append("...")
                passes.append("...")
                var_used = True
            continue
        if p.default is inspect.Parameter.empty:
            params.append(p.name)
        elif p.default is None:
            params.append(f"{p.name} = NULL")
        elif isinstance(p.default, bool):
            params.append(f"{p.name} = {'TRUE' if p.default else 'FALSE'}")
        elif isinstance(p.default, (int, float)):
            params.append(f"{p.name} = {p.default}")
        elif isinstance(p.default, str):
            params.append(f'{p.name} = "{p.default}"')
        else:
            params.append(f"{p.name} = NULL")
        passes.append(p.name)
    arglist = ", ".join(params)
    call_args = ", ".join([f'"{name}"'] + passes)  # no trailing comma for 0-arg
    return (
        f"#' {name} (generated binding)\n"
        f"#' @export\n"
        f"{name} <- function({arglist}) {{\n"
        f"  .mosaic_call({call_args})\n"
        f"}}\n"
    )


def generate() -> dict[str, str]:
    """Relative path under ``R/mosaicTpuTorch/`` -> file text."""
    from ..context import MosaicContext

    reg = MosaicContext.build("H3").register()
    chunks = [HEADER]
    for name in sorted(reg):
        try:
            sig = inspect.signature(reg[name])
        except (TypeError, ValueError):
            sig = inspect.Signature(
                [inspect.Parameter("args", inspect.Parameter.VAR_POSITIONAL)]
            )
        chunks.append(r_wrapper(name, sig))
    return {
        "R/functions.R": "\n".join(chunks),
        "DESCRIPTION": DESCRIPTION,
        "NAMESPACE": NAMESPACE,
    }


def main() -> int:
    files = generate()
    for rel, text in files.items():
        path = OUT / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(text)
    n = files["R/functions.R"].count(".mosaic_call(\"")
    print(f"generated {n} wrappers -> {OUT.relative_to(REPO)}/")
    return 0


if __name__ == "__main__":
    sys.exit(main())
