"""reprolint CLI of the port: static analysis and kernel contracts of
`src/repro_torch`, the counterpart of `repro.launch.lint`.

  PYTHONPATH=src python -m repro_torch.launch.lint --strict --device cpu

Runs both layers of `repro_torch.analysis` and prints findings with
fix-its:

  * Layer 1 — AST lint over the tree (default: src/repro_torch): the
    R202/R403/R601/R602/R701 rules, pure static, nothing is imported.
  * Layer 2 — contract checks over the LIVE kernel registries
    (C101-C601): every entry run on tiny real tensors on `--device`
    ("cuda", the default, launches the hand-written kernels; "cpu" runs
    their plain versions). Skip with --no-contracts (or run alone with
    --contracts-only).

Findings already recorded in the checked-in baseline
(`src/repro_torch/analysis/reprolint_baseline.txt`) are reported as
baselined and do not fail --strict; `--update-baseline` rewrites the
baseline from the current findings (each entry then needs a
justification comment in review). Exit status: 0 = clean (or
non-strict), 1 = new findings under --strict, 2 = bad invocation.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path


def _parser() -> argparse.ArgumentParser:
    """The reprolint argument parser (separate for --help testing)."""
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.lint",
        description="PyTorch-aware lint + kernel-contract checks of the "
                    "port",
    )
    ap.add_argument("--root", default=None, metavar="DIR",
                    help="tree to lint (default: src/repro_torch)")
    ap.add_argument("--strict", action="store_true",
                    help="exit 1 on any non-baselined finding (the CI gate)")
    ap.add_argument("--baseline", default=None, metavar="FILE",
                    help="suppression baseline path (default: the "
                         "checked-in src/repro_torch/analysis/"
                         "reprolint_baseline.txt)")
    ap.add_argument("--update-baseline", action="store_true",
                    help="rewrite the baseline from the current findings "
                         "(add a justification per line before committing)")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="machine-readable output (one object with "
                         "new/baselined/contract findings)")
    ap.add_argument("--no-contracts", action="store_true",
                    help="skip the Layer 2 registry contract checks "
                         "(pure-AST mode: nothing is imported)")
    ap.add_argument("--contracts-only", action="store_true",
                    help="run ONLY the Layer 2 contract checks")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the contract checks run their entries "
                         "(default cuda: raises without a card)")
    return ap


def _finding_dict(f, status: str) -> dict:
    """JSON form of one finding."""
    return {
        "code": f.code, "path": f.path, "line": f.line,
        "message": f.message, "fixit": f.fixit,
        "fingerprint": f.fingerprint, "status": status,
    }


def main(argv=None) -> int:
    """Run the configured lint layers; return the process exit status."""
    args = _parser().parse_args(argv)
    if args.no_contracts and args.contracts_only:
        print("error: --no-contracts and --contracts-only are exclusive",
              file=sys.stderr)
        return 2

    from repro_torch.analysis import lint_tree, load_baseline, write_baseline
    from repro_torch.analysis.baseline import split_baselined

    new, baselined, contract = [], [], []
    if not args.contracts_only:
        findings = lint_tree(args.root)
        if args.update_baseline:
            path = write_baseline(
                findings,
                Path(args.baseline) if args.baseline else None,
                keep=load_baseline(args.baseline),
            )
            print(f"baseline rewritten: {path} ({len(findings)} entries)")
            return 0
        baseline = load_baseline(args.baseline)
        new, baselined = split_baselined(findings, baseline)
    if not args.no_contracts:
        from repro_torch.analysis.contracts import check_contracts

        contract = check_contracts(device=args.device)

    if args.as_json:
        print(json.dumps({
            "new": [_finding_dict(f, "new") for f in new],
            "baselined": [_finding_dict(f, "baselined") for f in baselined],
            "contracts": [_finding_dict(f, "contract") for f in contract],
        }, indent=2))
    else:
        for f in new:
            print(f.render())
        for f in contract:
            print(f.render())
        if baselined:
            print(f"[{len(baselined)} baselined finding(s) suppressed; "
                  f"see src/repro_torch/analysis/reprolint_baseline.txt]")
        bad = len(new) + len(contract)
        print(f"reprolint: {bad} actionable finding(s), "
              f"{len(baselined)} baselined")
    if args.strict and (new or contract):
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
