"""span-context: obs spans must be entered, not just created.

``obs.span(...)`` returns a context manager; calling it without ``with``
(or ``stack.enter_context``) records nothing and silently unbalances the
enter/exit pairing the trace export relies on.
"""
from __future__ import annotations

import ast
from typing import Iterator, Set, Tuple

from repro_torch.analysis.lint import LintContext, Rule, dotted

_SPAN_ATTRS = frozenset({"span", "attach_context"})
_SPAN_RECEIVERS = frozenset({"obs", "trace", "tracer"})


def _is_span_call(node: ast.Call) -> bool:
    func = node.func
    if not (isinstance(func, ast.Attribute) and func.attr in _SPAN_ATTRS):
        return False
    recv = dotted(func.value) or ""
    leaf = recv.rsplit(".", 1)[-1]
    return leaf in _SPAN_RECEIVERS


class SpanContextRule(Rule):
    name = "span-context"
    description = ("obs.span()/attach_context() created but not entered "
                   "with `with` (or enter_context) — the span never "
                   "closes and the trace nesting breaks")

    def check(self, ctx: LintContext) -> Iterator[Tuple[int, int, str]]:
        entered: Set[int] = set()
        for node in ast.walk(ctx.tree):
            if isinstance(node, (ast.With, ast.AsyncWith)):
                for item in node.items:
                    entered.add(id(item.context_expr))
            elif (isinstance(node, ast.Call)
                  and isinstance(node.func, ast.Attribute)
                  and node.func.attr == "enter_context"):
                for arg in node.args:
                    entered.add(id(arg))
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Call) and _is_span_call(node) \
                    and id(node) not in entered:
                name = dotted(node.func) or "span"
                yield (node.lineno, node.col_offset,
                       f"{name}(...) is not entered via `with` — the span "
                       "is never closed")
