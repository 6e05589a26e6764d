"""unbounded-queue: serving-tier queues must be bounded and drainable.

The staged pipeline (``repro_torch/serve/pipeline.py``) is built on explicit
backpressure: every inter-stage queue has a capacity and every consumer
``get`` carries a timeout so ``stop()`` can always win.  An unbounded
``queue.Queue()`` / ``collections.deque()`` silently converts overload
into unbounded memory growth, and a bare blocking ``.get()`` turns a
dropped sentinel into a hung shutdown.  Both regressions type-check,
pass light tests, and only bite under sustained load — exactly the shape
this linter exists for.

Scoped to ``repro_torch/serve/``; the one legitimately unbounded structure
(the admission queue, whose bound is enforced by the admission gate, not
the container) carries an audited ``# repro-lint: disable`` at the site.
"""
from __future__ import annotations

import ast
from typing import Iterator, Tuple

from repro_torch.analysis.lint import LintContext, Rule, dotted

# Only the serving tier holds long-lived inter-thread queues; analysis /
# bench code may use deques as scratch containers freely.
SERVE_PATHS = ("repro_torch/serve/",)

# Constructor leaf names that build a FIFO whose capacity matters.
_QUEUE_CTORS = frozenset({"Queue", "LifoQueue", "PriorityQueue",
                          "SimpleQueue", "deque"})


def _in_scope(norm_path: str) -> bool:
    for prefix in SERVE_PATHS:
        if ("/" + prefix) in ("/" + norm_path) or \
                norm_path.startswith(prefix):
            return True
    return False


def _is_queueish(name: str) -> bool:
    """Receiver names that plausibly denote a queue object."""
    leaf = name.rsplit(".", 1)[-1].lower()
    return "queue" in leaf or leaf.endswith("_q") or leaf == "q"


def _kw(call: ast.Call, name: str) -> bool:
    return any(k.arg == name for k in call.keywords)


class UnboundedQueueRule(Rule):
    name = "unbounded-queue"
    description = ("unbounded queue construction or blocking `.get()` "
                   "without `timeout=` in repro_torch/serve/ — bound the "
                   "queue (maxsize/maxlen) and make consumers "
                   "interruptible")

    def check(self, ctx: LintContext) -> Iterator[Tuple[int, int, str]]:
        if not _in_scope(ctx.norm_path):
            return
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            callee = dotted(node.func) or ""
            leaf = callee.rsplit(".", 1)[-1]
            if leaf in _QUEUE_CTORS:
                if leaf == "SimpleQueue":
                    # SimpleQueue has no maxsize at all — never acceptable
                    # on the serving path.
                    yield (node.lineno, node.col_offset,
                           f"{callee}() cannot be bounded; use "
                           "queue.Queue(maxsize=...) instead")
                elif leaf == "deque":
                    # deque(maxlen=n) is bounded; a bare deque() (with or
                    # without an initial iterable) is not.
                    if not _kw(node, "maxlen"):
                        yield (node.lineno, node.col_offset,
                               f"{callee}() without maxlen= is unbounded; "
                               "pass maxlen= or gate admission explicitly")
                else:
                    # queue.Queue(n) / queue.Queue(maxsize=n) are bounded;
                    # Queue() and Queue(0) rely on the default (infinite).
                    bounded = bool(node.args) or _kw(node, "maxsize")
                    if not bounded:
                        yield (node.lineno, node.col_offset,
                               f"{callee}() without maxsize= is unbounded; "
                               "give the stage queue a capacity")
            elif (isinstance(node.func, ast.Attribute)
                  and node.func.attr == "get"
                  and not node.args and not _kw(node, "timeout")
                  and not _kw(node, "block")):
                recv = dotted(node.func.value) or ""
                if recv and _is_queueish(recv):
                    yield (node.lineno, node.col_offset,
                           f"{recv}.get() blocks forever; pass timeout= "
                           "so stop()/sentinel loss cannot hang the "
                           "consumer")
