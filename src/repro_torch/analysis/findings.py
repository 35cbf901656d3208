"""The finding type of the port's analysis passes.

A :class:`Finding` is a rule violation at a location: ``rule`` a stable
id (``SMEM001``), ``path`` a repo-relative path or a virtual label,
``line`` 1-based (0 where the pass has no lines), ``message`` what is
wrong, ``symbol`` the offending kernel or probe.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str
    path: str
    line: int
    message: str
    symbol: str = ""

    def render(self) -> str:
        loc = f"{self.path}:{self.line}" if self.line else self.path
        sym = f" [{self.symbol}]" if self.symbol else ""
        return f"{self.rule} {loc}{sym}: {self.message}"
