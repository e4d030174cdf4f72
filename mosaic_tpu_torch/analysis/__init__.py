"""Project-aware static analysis of the port (mosaic-lint).

Port of ``mosaic_tpu/analysis``, the stdlib-only linter, over
``mosaic_tpu_torch``: it imports nothing outside the standard library,
and nothing of the reference. ``engine.analyze`` parses every target
file once, runs file-scoped rules per module and project-scoped rules
over the whole tree (plus docs and committed goldens), applies inline
suppressions (``# lint: <rule>-ok (reason)``) and returns typed
:class:`Finding` records; the committed baseline is applied by the lint
tool (``python -m mosaic_tpu_torch.tools.lint``).

Rules shipped (see ``docs/TORCH_ARCHITECTURE.md`` "Static analysis"):

- ``capture-purity`` — host pulls, clocks, telemetry or print inside a
  CUDA graph capture (they break it, or run once and never at replay);
- ``env-read-after-staging`` — env knobs read inside a capture bake the
  capture-time value into every replay;
- ``dispatch-adoption`` — frontends route watchdog/retry through
  ``dispatch.guarded_call`` and keep no private cache of CUDA graphs or
  kernel-library loads;
- ``thread-context-adoption`` — worker threads must adopt telemetry
  sinks + trace context + fault plans;
- ``registry-drift`` — fault sites / spans / event stages / env knobs
  vs the port's committed registry, TORCH_ARCHITECTURE's span table,
  the port's perf_gate golden, and the docs;
- ``broad-except`` — ``except Exception`` must re-raise, convert into
  the runtime error taxonomy, or carry a justification;
- ``unbounded-cache`` — ``lru_cache(maxsize=None)`` pins CUDA tensors in
  card memory for the process lifetime;
- the hygiene floor: ``syntax``, ``unused-import``, ``whitespace``,
  ``bare-except``, ``print-in-lib``, plus ``suppression`` (malformed
  suppression comments).
"""

from .findings import Finding
from .registry import Rule, all_rules, get_rule, rule
from .engine import AnalysisResult, FileContext, ProjectContext, analyze
from .baseline import load_baseline, save_baseline, split_baselined
from .project_registry import build_registry

# importing the rule modules registers them
from . import rules as _rules  # noqa: F401

__all__ = [
    "AnalysisResult",
    "FileContext",
    "Finding",
    "ProjectContext",
    "Rule",
    "all_rules",
    "analyze",
    "build_registry",
    "get_rule",
    "load_baseline",
    "rule",
    "save_baseline",
    "split_baselined",
]
