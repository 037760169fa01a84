"""reprolint CLI for the port — Layer-1 AST lint over ``src/repro_torch``
with a committed regression baseline (the counterpart of
``repro/analysis/lint.py``).

Usage::

    PYTHONPATH=src python -m repro_torch.analysis.lint [--root .] [--json]
    PYTHONPATH=src python -m repro_torch.analysis.lint --update-baseline

Exit codes: 0 = clean (all findings grandfathered with justified baseline
entries), 1 = new findings, stale baseline entries, or malformed
baseline.  The baseline lives at ``LINT_BASELINE_TORCH.json`` in the repo
root and gates on the stable ``(rule, path, symbol)`` triple — see
``docs/analysis_torch.md#baseline``.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from repro_torch.analysis.findings import Baseline, apply_suppressions
from repro_torch.analysis.rules import run_rules

BASELINE_NAME = "LINT_BASELINE_TORCH.json"
PACKAGE = Path("src") / "repro_torch"


def find_repo_root(start: Path) -> Path:
    """Walk up from ``start`` to the directory holding src/repro_torch."""
    cur = start.resolve()
    for cand in [cur, *cur.parents]:
        if (cand / PACKAGE).is_dir():
            return cand
    return cur


def lint(root: Path, baseline_path: Path | None = None,
         update_baseline: bool = False, out=sys.stdout, as_json: bool = False) -> int:
    """Lint the port under ``root`` (``root`` itself when it holds no
    src/repro_torch, as a fixture mini-repo) against the baseline."""
    pkg = root / PACKAGE
    scan_root = pkg if pkg.is_dir() else root
    extra = [root / "tests" / "test_torch_launch_serve.py"]
    findings, sources = run_rules(scan_root, extra_paths=extra, rel_to=root)
    findings = apply_suppressions(findings, sources)

    bl = Baseline.load(baseline_path or root / BASELINE_NAME)
    if update_baseline:
        bl.write(findings, why="")
        print(f"wrote {len(findings)} entries to {bl.path} — fill in each "
              "'why' before committing (empty justifications fail the lint)",
              file=out)
        return 0

    errors = bl.validate()
    new, grandfathered, stale = bl.partition(findings)

    if as_json:
        json.dump({
            "new": [f.__dict__ for f in new],
            "grandfathered": [f.__dict__ for f in grandfathered],
            "stale_baseline": stale,
            "baseline_errors": errors,
        }, out, indent=2)
        out.write("\n")
    else:
        for f in new:
            print(f.render(), file=out)
        for e in errors:
            print(f"baseline: {e}", file=out)
        for s in stale:
            print(f"baseline: stale entry {s.get('rule')} {s.get('path')} "
                  f"[{s.get('symbol')}] matches no finding — the violation "
                  "was fixed; delete the entry", file=out)
        verdict = "FAIL" if (new or errors or stale) else "OK"
        print(f"reprolint (port): {verdict} — {len(sources)} files, {len(new)} new, "
              f"{len(grandfathered)} grandfathered, {len(stale)} stale",
              file=out)
    return 1 if (new or errors or stale) else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="repro_torch.analysis.lint",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=None,
                    help="repo root (default: auto-detect from cwd)")
    ap.add_argument("--baseline", default=None,
                    help=f"baseline path (default: <root>/{BASELINE_NAME})")
    ap.add_argument("--json", action="store_true", help="machine-readable output")
    ap.add_argument("--update-baseline", action="store_true",
                    help="rewrite the baseline from current findings "
                         "(justifications left empty — fill them in)")
    args = ap.parse_args(argv)
    root = Path(args.root) if args.root else find_repo_root(Path.cwd())
    baseline = Path(args.baseline) if args.baseline else None
    return lint(root, baseline_path=baseline,
                update_baseline=args.update_baseline, as_json=args.json)


if __name__ == "__main__":
    sys.exit(main())
