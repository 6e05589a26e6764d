"""bare-assert: library code must not validate with ``assert``.

``python -O`` strips assert statements, so an assert that guards
user-reachable input (stream shapes handed to kernels, service
arguments) silently stops guarding.  Library code raises
``ValueError``/``RuntimeError``; tests keep using asserts (they are not
linted).
"""
from __future__ import annotations

import ast
from typing import Iterator, Tuple

from repro_torch.analysis.lint import LintContext, Rule


class BareAssertRule(Rule):
    name = "bare-assert"
    description = ("`assert` used for validation in library code — "
                   "stripped under `python -O`; raise ValueError instead")

    def check(self, ctx: LintContext) -> Iterator[Tuple[int, int, str]]:
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Assert):
                yield (node.lineno, node.col_offset,
                       "assert statement in library code (vanishes under "
                       "-O); raise ValueError/RuntimeError")
