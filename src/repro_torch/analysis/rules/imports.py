"""worker-import: torch / repro_torch.obs must stay out of worker-safe modules.

``repro_torch/core/format.py`` and ``repro_torch/core/parallel_encode.py``
run inside spawned encode worker processes that must never pay (or trip
over) a torch import; ``repro_torch.obs`` must itself be importable without
torch so tracing can wrap the workers (``tests/test_torch_imports.py``
checks the same contract at run time).  A module-scope import regresses
that contract silently — everything keeps working on the host until a
worker pool starts.
"""
from __future__ import annotations

import ast
from typing import Iterator, List, Tuple

from repro_torch.analysis.lint import LintContext, Rule

# path suffix (posix) -> import roots banned at module scope.
WORKER_SAFE = (
    ("repro_torch/core/format.py", ("torch", "repro_torch.obs")),
    ("repro_torch/core/parallel_encode.py", ("torch", "repro_torch.obs")),
    ("repro_torch/obs/", ("torch",)),
)


def _banned_for(norm_path: str) -> Tuple[str, ...]:
    for suffix, banned in WORKER_SAFE:
        if suffix.endswith("/"):
            if ("/" + suffix) in ("/" + norm_path) or \
                    norm_path.startswith(suffix):
                return banned
        elif norm_path.endswith(suffix):
            return banned
    return ()


def _module_scope_imports(tree: ast.Module):
    """Top-level imports, descending into module-level if/try blocks but
    not into function or class bodies (those are lazy by construction)."""
    stack: List[ast.stmt] = list(tree.body)
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            yield node
        elif isinstance(node, (ast.If, ast.Try, ast.While, ast.For,
                               ast.With)):
            for field in ast.iter_child_nodes(node):
                if isinstance(field, ast.stmt):
                    stack.append(field)


def _hits(node, banned: Tuple[str, ...]) -> List[str]:
    names: List[str] = []
    if isinstance(node, ast.Import):
        names = [a.name for a in node.names]
    elif isinstance(node, ast.ImportFrom) and node.level == 0:
        mod = node.module or ""
        names = [mod] + [f"{mod}.{a.name}" if mod else a.name
                         for a in node.names]
    out = []
    for n in names:
        for b in banned:
            if n == b or n.startswith(b + "."):
                out.append(n)
                break
    return out


class WorkerImportRule(Rule):
    name = "worker-import"
    description = ("module-scope torch/repro_torch.obs import in a "
                   "worker-safe module (core/format.py, "
                   "core/parallel_encode.py, "
                   "obs/*) — defer it into the function that needs it")

    def check(self, ctx: LintContext) -> Iterator[Tuple[int, int, str]]:
        banned = _banned_for(ctx.norm_path)
        if not banned:
            return
        for node in _module_scope_imports(ctx.tree):
            for name in _hits(node, banned):
                yield (node.lineno, node.col_offset,
                       f"module-scope import of {name!r} in worker-safe "
                       f"module (banned roots here: {', '.join(banned)})")
