"""frozen-mutation: PreparedCOO / plan / stream arrays are shared, not owned.

The registry hands the same ``PreparedCOO`` and ``SerpensMatrix`` arrays
to every plan of a matrix (repartitions reuse the cached sort; shards of
an aligned single-shard plan are *views* into the stream).  Writing any
of them in place corrupts every other holder — the delta path builds new
arrays and splices instead.
"""
from __future__ import annotations

import ast
from typing import Iterator, Optional, Tuple

from repro_torch.analysis.lint import LintContext, Rule, dotted

# Variable names that conventionally hold shared prepared/encoded objects.
RECEIVERS = frozenset({
    "prep", "prepared", "new_prep", "plan", "new_plan", "plan1",
    "sm", "mat",
})
# Array fields of PreparedCOO / SerpensMatrix / ChannelShardPlan that are
# shared between holders.
FROZEN_FIELDS = frozenset({
    "rows", "cols", "vals", "order", "bucket_key", "packed",
    "idx", "val", "seg_ids", "aux_rows", "aux_cols", "aux_vals",
    "row_perm",
})


def _frozen_target(node: ast.expr) -> Optional[str]:
    """Dotted name if ``node`` is a write into a shared stream array."""
    # sm.idx[...] = x  /  sm.idx[...] += x
    if isinstance(node, ast.Subscript):
        inner = node.value
        if isinstance(inner, ast.Attribute) and \
                inner.attr in FROZEN_FIELDS:
            root = dotted(inner.value)
            if root in RECEIVERS or (root or "").startswith("self."):
                leaf = (root or "").rsplit(".", 1)[-1]
                if root in RECEIVERS or leaf in RECEIVERS:
                    return f"{root}.{inner.attr}[...]"
        return None
    # sm.idx = x (rebinding a shared field on a shared object)
    if isinstance(node, ast.Attribute) and node.attr in FROZEN_FIELDS:
        root = dotted(node.value)
        if root in RECEIVERS:
            return f"{root}.{node.attr}"
    return None


class FrozenMutationRule(Rule):
    name = "frozen-mutation"
    description = ("in-place write to a shared PreparedCOO/SerpensMatrix/"
                   "plan array (rows/cols/vals/idx/val/seg_ids/aux_*/"
                   "row_perm) — build new arrays and splice instead")

    def check(self, ctx: LintContext) -> Iterator[Tuple[int, int, str]]:
        for node in ast.walk(ctx.tree):
            targets = ()
            if isinstance(node, ast.Assign):
                targets = node.targets
            elif isinstance(node, ast.AugAssign):
                targets = (node.target,)
            for t in targets:
                name = _frozen_target(t)
                if name:
                    yield (node.lineno, node.col_offset,
                           f"in-place write to shared stream array "
                           f"{name}")
