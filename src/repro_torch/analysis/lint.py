"""Repo-rule AST linter: the bug classes this codebase has actually shipped.

Generic linters don't know that ``core/format.py`` must stay importable in
a torch-free worker process, that ``SpMVService`` must never dispatch to the
device while holding its lock, or that ``PreparedCOO`` arrays are shared
between cached plans and must never be written in place.  Each such
contract is a :class:`Rule` over the module's ``ast``; findings come back
as :class:`~repro_torch.analysis.diagnostics.Diagnostics` with file/line
locations.

Suppression: append ``# repro-lint: disable=<rule>[,<rule>...]`` (or
``disable=all``) to the offending line.  Suppressed findings are counted
but not reported.

CLI: ``python -m repro_torch.analysis lint [paths...]`` (default:
``src/repro_torch``).
"""
from __future__ import annotations

import ast
import dataclasses
import os
import re
from typing import Iterable, Iterator, List, Optional, Sequence, Tuple

from repro_torch.analysis.diagnostics import Diagnostic, Diagnostics

_SUPPRESS_RE = re.compile(r"#\s*repro-lint:\s*disable=([\w\-, ]+)")


@dataclasses.dataclass
class LintContext:
    """Everything a rule sees for one file."""

    path: str                      # as given / display form
    norm_path: str                 # posix-normalized, for suffix matching
    tree: ast.Module
    lines: List[str]               # 1-indexed via lines[line - 1]


class Rule:
    """Base class: subclasses set ``name``/``description`` and yield
    ``(line, col, message)`` tuples from :meth:`check`."""

    name: str = ""
    description: str = ""

    def check(self, ctx: LintContext) -> Iterator[Tuple[int, int, str]]:
        raise NotImplementedError


def dotted(node: ast.AST) -> Optional[str]:
    """``a.b.c`` as a string for Name/Attribute chains, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def suppressed_rules(line_text: str) -> List[str]:
    m = _SUPPRESS_RE.search(line_text)
    if not m:
        return []
    return [r.strip() for r in m.group(1).split(",") if r.strip()]


def lint_source(source: str, path: str,
                rules: Sequence[Rule]) -> Tuple[Diagnostics, int]:
    """Lint one file's text. Returns (diagnostics, suppressed_count)."""
    d = Diagnostics()
    norm = path.replace(os.sep, "/")
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as e:
        d.add("syntax", f"cannot parse: {e.msg}", path=path,
              line=e.lineno or 1, col=e.offset or 0)
        return d, 0
    ctx = LintContext(path=path, norm_path=norm, tree=tree,
                      lines=source.splitlines())
    suppressed = 0
    for rule in rules:
        for line, col, msg in rule.check(ctx):
            text = ctx.lines[line - 1] if 0 < line <= len(ctx.lines) else ""
            names = suppressed_rules(text)
            if rule.name in names or "all" in names:
                suppressed += 1
                continue
            d.findings.append(Diagnostic(rule=rule.name, message=msg,
                                         path=path, line=line, col=col))
    return d, suppressed


def iter_py_files(paths: Iterable[str]) -> Iterator[str]:
    for p in paths:
        if os.path.isfile(p):
            if p.endswith(".py"):
                yield p
        else:
            for root, dirs, files in os.walk(p):
                dirs[:] = sorted(x for x in dirs
                                 if x not in ("__pycache__", ".git"))
                for f in sorted(files):
                    if f.endswith(".py"):
                        yield os.path.join(root, f)


def lint_paths(paths: Iterable[str],
               rules: Optional[Sequence[Rule]] = None
               ) -> Tuple[Diagnostics, int, int]:
    """Lint files/trees. Returns (diagnostics, suppressed, files_scanned)."""
    if rules is None:
        from repro_torch.analysis.rules import ALL_RULES
        rules = ALL_RULES
    d = Diagnostics()
    suppressed = 0
    nfiles = 0
    for path in iter_py_files(paths):
        nfiles += 1
        with open(path, "r", encoding="utf-8") as f:
            src = f.read()
        fd, fs = lint_source(src, path, rules)
        d.extend(fd)
        suppressed += fs
    return d, suppressed, nfiles
