"""CLI (copy of ``edl_tpu.analysis.__main__``): ``python -m
edl_tpu_torch.analysis lint`` (the CI gate) and ``python -m
edl_tpu_torch.analysis lockgraph-selftest`` (proves the race detector
catches its seeded hazards).

``lint`` exits 1 on any unsuppressed finding; ``--json PATH`` writes
the machine-readable result (findings + the full suppression inventory
with reasons).
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def _cmd_lint(args) -> int:
    from edl_tpu_torch.analysis.core import run_lint
    checks = args.check or None
    result = run_lint(args.root, checks=checks)
    for f in result.findings:
        print(f.render())
    if args.json:
        with open(args.json, "w", encoding="utf-8") as fh:
            json.dump(result.to_dict(), fh, indent=2, sort_keys=True)
    n_sup = len(result.suppressed)
    if result.findings:
        print(f"edl-lint: {len(result.findings)} finding(s) "
              f"({n_sup} suppressed) across checks: "
              f"{', '.join(result.checks_run)}", file=sys.stderr)
        return 1
    print(f"edl-lint: clean ({', '.join(result.checks_run)}; "
          f"{n_sup} suppression(s) in force)")
    return 0


def _cmd_lockgraph_selftest(args) -> int:
    del args
    from edl_tpu_torch.analysis.lockgraph import selftest
    return selftest(verbose=True)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="edl_tpu_torch.analysis",
        description="edl-lint: invariant checkers + lock-order analysis")
    sub = parser.add_subparsers(dest="cmd", required=True)

    lint = sub.add_parser("lint", help="run the AST checkers (CI gate)")
    lint.add_argument("--root", default=os.getcwd(),
                      help="repo root (default: cwd)")
    lint.add_argument("--check", action="append",
                      help="run only this checker (repeatable)")
    lint.add_argument("--json", default=None,
                      help="write the machine-readable result here")
    lint.set_defaults(fn=_cmd_lint)

    lg = sub.add_parser("lockgraph-selftest",
                        help="prove the lock-order detector catches the "
                             "seeded ABBA pair and the queue hazard")
    lg.set_defaults(fn=_cmd_lockgraph_selftest)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
