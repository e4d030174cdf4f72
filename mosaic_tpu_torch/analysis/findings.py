"""The typed finding record every rule emits."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation at one source location.

    ``path`` is repo-relative POSIX; ``line`` is 1-based (0 for
    whole-file/project findings with no anchor). ``hint`` is the fix
    hint shown to the developer — every rule must say how to get green,
    not just what is red.
    """

    rule: str
    path: str
    line: int
    message: str
    severity: str = "error"
    hint: str = ""

    def key(self) -> str:
        """Baseline identity: stable across line drift (a baselined
        finding must not resurface because unrelated edits moved it)."""
        return f"{self.rule}::{self.path}::{self.message}"

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def render(self) -> str:
        loc = f"{self.path}:{self.line}" if self.line else self.path
        tail = f"  [fix: {self.hint}]" if self.hint else ""
        return f"{loc}: {self.rule}: {self.message}{tail}"
