"""CLI for the static verification subsystem.

    python -m repro_torch.analysis lint [paths...] [--list-rules]
    python -m repro_torch.analysis verify [--mode full|fast] [--npz FILE ...]

``lint`` runs the repo-rule AST linter (default scan root:
``src/repro_torch``) and exits non-zero on unsuppressed findings.

``verify`` with no ``--npz`` runs the built-in plan suite: a matrix zoo
(power-law / banded / uniform, incl. empty and duplicate-entry cases)
crossed with plan specs (single / row / col, modulo / balanced lanes),
value dtypes and spill configs — every plan is proven against the full
invariant set with the source COO as ground truth.  ``--npz`` instead
verifies matrices saved as ``rows``/``cols``/``vals``/``shape`` arrays.
Exit status 0 only if every plan verifies clean.  The plans are encoded
by the port's own ``format``/``partition`` and ``data.matrices``.
"""
from __future__ import annotations

import argparse
import sys
import time


def _cmd_lint(args) -> int:
    from repro_torch.analysis.lint import lint_paths
    from repro_torch.analysis.rules import ALL_RULES
    if args.list_rules:
        for rule in ALL_RULES:
            print(f"{rule.name:20s} {rule.description}")
        return 0
    paths = args.paths or ["src/repro_torch"]
    diags, suppressed, nfiles = lint_paths(paths)
    for d in diags:
        print(d.format())
    status = "FAIL" if diags.findings else "OK"
    print(f"repro-lint: {status} — {len(diags.findings)} finding(s), "
          f"{suppressed} suppressed, {nfiles} file(s) scanned")
    return 1 if diags.findings else 0


def _suite_cases():
    """(name, rows, cols, vals, shape, config, spec) for the plan zoo."""
    import numpy as np

    from repro_torch.core import format as F
    from repro_torch.core import partition as PT
    from repro_torch.data import matrices as M

    base = dict(segment_width=256, lanes=8, sublanes=4, raw_window=2)
    cfgs = {
        "paper": F.SerpensConfig(**base),
        "spill": F.SerpensConfig(**base, spill_hot_rows=True,
                                 lane_balance=1.1),
        "bf16": F.SerpensConfig(**base, spill_hot_rows=True,
                                value_dtype="bfloat16"),
        "chunk2": F.SerpensConfig(segment_width=128, lanes=8, sublanes=4,
                                  raw_window=4, tiles_per_chunk=2),
        "wide": F.SerpensConfig(segment_width=1 << 16, lanes=4,
                                sublanes=4, raw_window=2),
    }
    mats = {
        "power_law": M.power_law_graph(600, 6_000, seed=3),
        "banded": M.banded(512, 9, seed=5),
        "uniform": M.uniform_random(300, 900, 4_000, seed=7),
        "dupes": (np.array([0, 0, 0, 5, 5, 9]), np.array([1, 1, 2, 0, 0, 3]),
                  np.array([1.0, 2.0, 3.0, 4.0, 5.0, 6.0], np.float32)),
        "empty": (np.zeros(0, np.int64), np.zeros(0, np.int64),
                  np.zeros(0, np.float32)),
    }
    shapes = {"power_law": (600, 600), "banded": (512, 512),
              "uniform": (300, 900), "dupes": (10, 10), "empty": (16, 16)}
    specs = {
        "single": PT.PlanSpec("single", 1),
        "row2": PT.PlanSpec("row", 2),
        "row4": PT.PlanSpec("row", 4),
        "col2": PT.PlanSpec("col", 2),
        "bal": PT.PlanSpec("single", 1, lane_assign="balanced"),
        "row2bal": PT.PlanSpec("row", 2, lane_assign="balanced"),
        "col2bal": PT.PlanSpec("col", 2, lane_assign="balanced"),
    }
    for mname, (r, c, v) in mats.items():
        for cname, cfg in cfgs.items():
            if cname == "wide" and mname != "uniform":
                continue       # the 65536-wide segment case once is enough
            for sname, spec in specs.items():
                if mname == "empty" and sname not in ("single", "row2"):
                    continue
                yield (f"{mname}/{cname}/{sname}", r, c, v,
                       shapes[mname], cfg, spec)


def _cmd_verify(args) -> int:
    import numpy as np

    from repro_torch.analysis.verify import verify_plan
    from repro_torch.core import partition as PT

    failures = 0
    plans = 0
    t0 = time.perf_counter()
    if args.npz:
        from repro_torch.core import format as F
        for path in args.npz:
            data = np.load(path)
            rows, cols, vals = data["rows"], data["cols"], data["vals"]
            shape = tuple(int(x) for x in data["shape"])
            plan = PT.make_plan(rows, cols, vals, shape, F.SerpensConfig())
            d = verify_plan(plan, rows, cols, vals, mode=args.mode)
            plans += 1
            if not d.ok:
                failures += 1
                print(f"{path}: FAIL")
                print(d.format(limit=10))
            else:
                print(f"{path}: ok")
    else:
        for name, r, c, v, shape, cfg, spec in _suite_cases():
            try:
                plan = PT.make_plan(r, c, v, shape, cfg, spec)
            except ValueError as e:
                print(f"{name}: skipped ({e})")
                continue
            d = verify_plan(plan, r, c, v, mode=args.mode)
            plans += 1
            if not d.ok:
                failures += 1
                print(f"{name}: FAIL ({len(d.errors)} error(s))")
                print(d.format(limit=10))
            elif args.verbose:
                print(f"{name}: ok")
    dt = time.perf_counter() - t0
    status = "FAIL" if failures else "OK"
    print(f"repro-verify: {status} — {plans} plan(s) verified "
          f"(mode={args.mode}), {failures} failed, {dt:.1f}s")
    return 1 if failures else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd", required=True)

    lp = sub.add_parser("lint", help="run the repo-rule AST linter")
    lp.add_argument("paths", nargs="*",
                    help="files/dirs to scan "
                    "(default: src/repro_torch)")
    lp.add_argument("--list-rules", action="store_true",
                    help="print the rule table and exit")
    lp.set_defaults(func=_cmd_lint)

    vp = sub.add_parser("verify", help="verify Serpens streams/plans")
    vp.add_argument("--mode", default="full", choices=("full", "fast"))
    vp.add_argument("--npz", nargs="*", default=None,
                    help="verify matrices from .npz (rows/cols/vals/shape)")
    vp.add_argument("-v", "--verbose", action="store_true")
    vp.set_defaults(func=_cmd_verify)

    args = ap.parse_args(argv)
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())
