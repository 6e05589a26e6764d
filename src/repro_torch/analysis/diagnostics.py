"""Structured findings shared by the stream verifier and the AST linter.

Both tools accumulate :class:`Diagnostic` records into a
:class:`Diagnostics` report instead of raising on the first failure, so a
corrupted stream (or a dirty source tree) yields the complete picture in
one pass: every rule that fired, where, and how badly.  Callers that want
the old assert-style behaviour use :meth:`Diagnostics.raise_if_error`.

A finding carries two alternative location vocabularies:

* stream coordinates (``shard`` / ``slot`` / ``lane``) for verifier rules
  over :class:`~repro_torch.core.format.SerpensMatrix` /
  :class:`~repro_torch.core.partition.ChannelShardPlan` objects, where ``slot``
  is the flat tile index ``t`` into ``idx[t, sublane, lane]``;
* source coordinates (``path`` / ``line`` / ``col``) for lint rules.

Unused fields stay ``None`` and are omitted from the rendered line.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Iterator, List, Optional

ERROR = "error"
WARNING = "warning"


@dataclasses.dataclass(frozen=True)
class Diagnostic:
    """One finding: which rule fired, how severe, and where."""

    rule: str
    message: str
    severity: str = ERROR
    # Stream coordinates (verifier findings).
    shard: Optional[int] = None
    slot: Optional[int] = None
    lane: Optional[int] = None
    # Source coordinates (lint findings).
    path: Optional[str] = None
    line: Optional[int] = None
    col: Optional[int] = None

    def location(self) -> str:
        if self.path is not None:
            loc = self.path
            if self.line is not None:
                loc += f":{self.line}"
                if self.col is not None:
                    loc += f":{self.col}"
            return loc
        parts = []
        if self.shard is not None:
            parts.append(f"shard={self.shard}")
        if self.slot is not None:
            parts.append(f"slot={self.slot}")
        if self.lane is not None:
            parts.append(f"lane={self.lane}")
        return " ".join(parts)

    def format(self) -> str:
        loc = self.location()
        head = f"{loc}: " if loc else ""
        return f"{head}{self.severity}[{self.rule}] {self.message}"


class Diagnostics:
    """An append-only collection of findings with summary helpers."""

    def __init__(self, findings: Iterable[Diagnostic] = ()):
        self.findings: List[Diagnostic] = list(findings)

    def add(self, rule: str, message: str, *, severity: str = ERROR,
            shard: Optional[int] = None, slot: Optional[int] = None,
            lane: Optional[int] = None, path: Optional[str] = None,
            line: Optional[int] = None, col: Optional[int] = None) -> None:
        self.findings.append(Diagnostic(
            rule=rule, message=message, severity=severity, shard=shard,
            slot=slot, lane=lane, path=path, line=line, col=col))

    def extend(self, other: "Diagnostics") -> None:
        self.findings.extend(other.findings)

    def __iter__(self) -> Iterator[Diagnostic]:
        return iter(self.findings)

    def __len__(self) -> int:
        return len(self.findings)

    @property
    def errors(self) -> List[Diagnostic]:
        return [d for d in self.findings if d.severity == ERROR]

    @property
    def ok(self) -> bool:
        """True when no *error*-severity findings exist (warnings pass)."""
        return not self.errors

    def by_rule(self, rule: str) -> List[Diagnostic]:
        return [d for d in self.findings if d.rule == rule]

    def rules_fired(self) -> List[str]:
        seen: List[str] = []
        for d in self.findings:
            if d.rule not in seen:
                seen.append(d.rule)
        return seen

    def format(self, limit: Optional[int] = None) -> str:
        shown = self.findings if limit is None else self.findings[:limit]
        lines = [d.format() for d in shown]
        hidden = len(self.findings) - len(shown)
        if hidden > 0:
            lines.append(f"... and {hidden} more finding(s)")
        return "\n".join(lines)

    def raise_if_error(self, exc_type: type = AssertionError) -> None:
        """Raise ``exc_type`` listing every error finding (max 20 shown)."""
        errs = self.errors
        if errs:
            raise exc_type(
                f"{len(errs)} verification error(s):\n"
                + Diagnostics(errs).format(limit=20))
