"""Generate docs/TORCH_API.md from the port's live function registry.

Port of the reference's ``tools/generate_api_docs.py``, in its layout: the
registry of ``MosaicContext.build("H3").register()`` is the source of
truth, each registered name is emitted with its signature and docstring
summary grouped by family, then the public names of
``mosaic_tpu_torch.obs``. The doc can never list a function that does not
exist (``tests/test_torch_tools_docs.py`` regenerates and diffs).

    python -m mosaic_tpu_torch.tools.generate_api_docs
"""

from __future__ import annotations

import inspect
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
OUT = REPO / "docs" / "TORCH_API.md"


def _summary(fn) -> str:
    doc = inspect.getdoc(fn) or ""
    first = doc.split("\n\n")[0].replace("\n", " ").strip()
    return first if len(first) <= 160 else first[:157] + "..."


def _sig(fn) -> str:
    try:
        s = str(inspect.signature(fn))
    except (TypeError, ValueError):
        return "(...)"
    return s if len(s) <= 90 else "(...)"


def _row(name: str, obj) -> str:
    sig = _sig(obj).replace("|", "\\|")
    summ = _summary(obj).replace("|", "\\|")
    return f"| `{name}{sig}` | {summ} |"


def _obs_lines() -> list[str]:
    """The `mosaic_tpu_torch.obs` section: introspected from the package's
    public API so the doc cannot list a name that does not exist."""
    from .. import obs

    lines = [
        "## Observability (`mosaic_tpu_torch.obs`)",
        "",
        "Tracing, typed metrics, and exporters over the "
        "`runtime/telemetry.py` event spine (see TORCH_ARCHITECTURE.md). "
        "CLI companions: `python -m mosaic_tpu_torch.tools.trace_report` "
        "(per-stage breakdown + `--against` diff), "
        "`python -m mosaic_tpu_torch.tools.perf_gate` (regression gate over "
        "`mosaic_tpu_torch/tools/goldens/perf_gate.json`).",
        "",
        "| Name | Summary |",
        "|---|---|",
    ]
    for n in sorted(obs.__all__):
        o = getattr(obs, n)
        if inspect.ismodule(o):
            continue
        if inspect.isfunction(o) or inspect.isclass(o):
            lines.append(_row(n, o))
        else:
            lines.append(
                f"| `{n}` | The process default metrics registry "
                f"(module-level `counter`/`gauge`/`histogram` target "
                f"it). |"
            )
    lines.append("")
    return lines


def generate() -> str:
    from ..context import MosaicContext

    reg = MosaicContext.build("H3").register()
    lines = [
        "# API reference of the PyTorch port",
        "",
        "Generated by `python -m mosaic_tpu_torch.tools.generate_api_docs` "
        f"from the live registry of `mosaic_tpu_torch` ({len(reg)} "
        "registered names) — regenerate after adding functions. Entry "
        "points run on the card unless the caller passes `device=\"cpu\"`. "
        "The JAX package's reference is `docs/API.md`.",
        "",
    ]
    used: set[str] = set()

    def family(title, names):
        if not names:
            return
        lines.extend([f"## {title}", "", "| Function | Summary |", "|---|---|"])
        for n in names:
            lines.append(_row(n, reg[n]))
            used.add(n)
        lines.append("")

    family("ST_ geometry functions", sorted(n for n in reg if n.startswith("st_")))
    family("Grid / index functions", sorted(n for n in reg if n.startswith("grid_")))
    family("RST_ raster functions", sorted(n for n in reg if n.startswith("rst_")))
    family(
        "Constructors, converters, aggregates, utilities",
        sorted(n for n in reg if n not in used),
    )
    lines.extend(_obs_lines())
    return "\n".join(lines) + "\n"


def main() -> int:
    OUT.write_text(generate())
    print(f"wrote {OUT.relative_to(REPO)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
