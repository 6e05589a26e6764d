"""lock-blocking-call & stat-lock: the serving-path concurrency contracts.

``SpMVService`` / ``MatrixRegistry`` (``repro_torch/core/registry.py``,
``repro_torch/serve/``) have shipped real bugs in exactly these shapes
(torn reads, a result-routing race): device dispatch or a multi-second
encode executed while a lock was held, and metric/stat mutations outside
the lock that guards their readers.

The blocking names are the port's own: its operators' ``matvec``/
``matmat``/``matvec_fused``, the stream dispatch ``run_stream``/
``run_stream_fused``, the encoders.  Where the reference names
``block_until_ready`` (wait for the device) and ``device_put`` (a host→
device copy), the port's counterparts are ``synchronize``
(``torch.cuda.synchronize``, ``Event.synchronize``) and ``device_arrays``
(``repro_torch.kernels.ops.device_arrays``).
"""
from __future__ import annotations

import ast
from typing import Iterator, List, Optional, Tuple

from repro_torch.analysis.lint import LintContext, Rule, dotted

# Callee names that block or dispatch: holding a lock across any of these
# serializes the serving path (or deadlocks against the callee's own lock).
BLOCKING_CALLS = frozenset({
    "matvec", "matmat", "matvec_fused", "synchronize", "device_arrays",
    "sleep", "join", "shutdown", "prepare", "encode", "encode_prepared",
    "encode_reference", "make_plan", "plan_from_prepared",
    "plan_apply_delta", "run_stream", "run_stream_fused",
})


def _is_lockish(name: Optional[str]) -> bool:
    if not name:
        return False
    leaf = name.rsplit(".", 1)[-1].lower()
    return ("lock" in leaf or leaf.endswith("_cv") or "cond" in leaf)


def _lockish_classes(tree: ast.Module) -> List[ast.ClassDef]:
    """Classes that create a lock/condition in any method."""
    out = []
    for cls in [n for n in ast.walk(tree) if isinstance(n, ast.ClassDef)]:
        for node in ast.walk(cls):
            if (isinstance(node, ast.Assign)
                    and isinstance(node.value, ast.Call)):
                callee = dotted(node.value.func) or ""
                if callee.rsplit(".", 1)[-1] in ("Lock", "RLock",
                                                 "Condition"):
                    out.append(cls)
                    break
    return out


class LockBlockingCallRule(Rule):
    name = "lock-blocking-call"
    description = ("encode/dispatch/blocking call made while lexically "
                   "inside a `with <lock>:` block — move the slow work "
                   "outside the critical section")

    def check(self, ctx: LintContext) -> Iterator[Tuple[int, int, str]]:
        findings: List[Tuple[int, int, str]] = []

        def visit(node: ast.AST, locks: Tuple[str, ...]) -> None:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)) and locks:
                # A nested def runs later, not under this lock.
                return
            if isinstance(node, ast.With):
                held = list(locks)
                for item in node.items:
                    name = dotted(item.context_expr)
                    if _is_lockish(name):
                        held.append(name)
                for child in node.body:
                    visit(child, tuple(held))
                return
            if isinstance(node, ast.Call) and locks:
                func = node.func
                if isinstance(func, ast.Attribute):
                    recv = dotted(func.value)
                    if func.attr in BLOCKING_CALLS:
                        findings.append((
                            node.lineno, node.col_offset,
                            f"call to {func.attr!r} while holding "
                            f"{locks[-1]!r}"))
                    elif func.attr == "wait" and recv not in locks:
                        # cv.wait() on the held condition releases it (the
                        # legitimate idiom); waiting on anything else
                        # blocks with the lock held.
                        findings.append((
                            node.lineno, node.col_offset,
                            f"wait on {recv or '<expr>'!r} while holding "
                            f"{locks[-1]!r} (only the held condition "
                            "variable's own wait releases the lock)"))
            for child in ast.iter_child_nodes(node):
                visit(child, locks)

        visit(ctx.tree, ())
        yield from findings


class StatLockRule(Rule):
    name = "stat-lock"
    description = ("metric/stat mutation (`self._m_*.inc/...`, "
                   "`self.stats.* +=`) outside the owning class's lock — "
                   "readers under the lock see torn updates")

    _MUTATORS = frozenset({"inc", "add", "observe", "set"})

    def check(self, ctx: LintContext) -> Iterator[Tuple[int, int, str]]:
        findings: List[Tuple[int, int, str]] = []

        def visit(node: ast.AST, in_lock: bool) -> None:
            if isinstance(node, ast.With):
                held = in_lock or any(
                    _is_lockish(dotted(i.context_expr)) for i in node.items)
                for child in node.body:
                    visit(child, held)
                for item in node.items:
                    visit(item, in_lock)
                return
            if not in_lock:
                target = None
                if (isinstance(node, ast.Call)
                        and isinstance(node.func, ast.Attribute)
                        and node.func.attr in self._MUTATORS):
                    recv = dotted(node.func.value) or ""
                    if recv.startswith("self._m_") or \
                            recv.startswith("self.stats"):
                        target = f"{recv}.{node.func.attr}()"
                elif isinstance(node, (ast.AugAssign, ast.Assign)):
                    tgts = ([node.target] if isinstance(node, ast.AugAssign)
                            else node.targets)
                    for t in tgts:
                        name = dotted(t)
                        if name and name.startswith("self.stats."):
                            target = name
                if target:
                    findings.append((node.lineno, node.col_offset,
                                     f"{target} mutated outside the lock"))
            for child in ast.iter_child_nodes(node):
                if isinstance(child, (ast.FunctionDef,
                                      ast.AsyncFunctionDef, ast.Lambda)):
                    continue
                if isinstance(child, ast.With):
                    visit(child, in_lock)
                else:
                    visit(child, in_lock)

        for cls in _lockish_classes(ctx.tree):
            for meth in cls.body:
                if not isinstance(meth, (ast.FunctionDef,
                                         ast.AsyncFunctionDef)):
                    continue
                if meth.name in ("__init__", "__post_init__"):
                    continue   # single-threaded construction
                for stmt in meth.body:
                    visit(stmt, False)
        yield from findings
