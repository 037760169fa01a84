"""Noise-aware bench-ledger diff of the port — port of
``scripts/bench_diff.py``: compares two ``repro-bench-ledger/v1`` files
(``paper/ledger.py``) and fails, exit 1 with REGRESSION lines, when a tracked
series got worse.  The noise contract lives in the ledger itself:

* ``clock: "virtual"`` series are deterministic (engine steps, admission-wait
  steps, packed weight bytes); these GATE, each within its own relative
  tolerance band (``tol``: 0 for exact integers, more for backend-numeric
  floats like the kv logit gap).  A virtual series of the baseline that the
  new run lacks is a regression too.
* ``clock: "wall"`` series are measured on whatever machine ran the bench;
  these are REPORTED (delta %) but never gate.  Baseline wall values are the
  mean of the better half of every baseline run's value (the
  noise-only-adds-time estimator of ``paper/common.timed_robust``).

A ledger's records may come from the port (``meta.torch_version``) or from
the reference (``meta.jax_version``), so a port run diffs against the
reference's committed ``BENCH_SERVE.json`` and ``BENCH_KERNELS.json`` as
well as against the port's own ``BENCH_SERVE_TORCH.json`` and
``BENCH_KERNELS_TORCH.json``.

    PYTHONPATH=src python -m repro_torch.paper.bench_diff --baseline BENCH_SERVE.json \\
        --new artifacts/bench_torch/BENCH_SERVE.candidate.json [--report r.txt]
    PYTHONPATH=src python -m repro_torch.paper.bench_diff   # self-check: last vs
                                                        # prior runs of the port's ledgers

In both modes a ledger's comparison value is its LAST run's series
(candidate files hold one run); baseline wall values pool every baseline
run.  Exit codes: 0 clean (improvements included), 1 any gated regression or
an invalid or missing ledger.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

from repro_torch.paper import ledger

#: floor for relative comparisons, so that a 0-valued exact series still
#: diffs cleanly (0 vs 0) and never divides by zero
_EPS = 1e-12


def _fastest_half(values, direction):
    """Mean of the better half of the baseline samples: for wall series,
    where noise only ever pushes values the worse way."""
    vs = sorted(values, reverse=(direction == "higher"))
    keep = vs[: max(1, len(vs) // 2 + len(vs) % 2)]
    return sum(keep) / len(keep)


def diff_ledgers(base: dict, new: dict) -> dict:
    """Compare the last run of ``new`` against ``base``.  Returns
    {"regressions": [...], "improvements": [...], "lines": [...],
     "missing": [...]}; lines is the human report."""
    base_runs = base["runs"]
    new_series = new["runs"][-1]["series"]
    base_last = base_runs[-1]["series"]
    lines, regressions, improvements, missing = [], [], [], []

    for name in sorted(set(base_last) | set(new_series)):
        b, n = base_last.get(name), new_series.get(name)
        if n is None:
            missing.append(name)
            lines.append(f"MISSING   {name}: tracked in the baseline but "
                         f"absent from the new run")
            continue
        if b is None:
            lines.append(f"NEW       {name}: {n['value']:.6g} {n['unit']} "
                         f"(no baseline yet)")
            continue
        direction, tol = b["direction"], float(b["tol"])
        if b["clock"] == "wall":
            bval = _fastest_half(
                [r["series"][name]["value"] for r in base_runs
                 if name in r["series"]], direction)
        else:
            bval = b["value"]
        nval = n["value"]
        rel = (nval - bval) / max(abs(bval), _EPS)
        worse = rel > tol if direction == "lower" else rel < -tol
        better = rel < -_EPS if direction == "lower" else rel > _EPS
        desc = (f"{name}: {bval:.6g} -> {nval:.6g} {n['unit']} "
                f"({rel * 100:+.2f}%, want {direction}, tol "
                f"{tol * 100:g}%)")
        if b["clock"] == "wall":
            lines.append(f"wall      {desc}  [report-only]")
        elif worse:
            regressions.append(name)
            lines.append(f"REGRESSION {desc}")
        elif better:
            improvements.append(name)
            lines.append(f"improved  {desc}")
        else:
            lines.append(f"ok        {desc}")
    # a tracked virtual series vanishing IS a gate failure: otherwise
    # deleting the series would be the easiest way to pass
    regressions.extend(m for m in missing
                       if base_last[m]["clock"] == "virtual")
    return {"regressions": regressions, "improvements": improvements,
            "missing": missing, "lines": lines}


def _compare(baseline_path, new_path, out) -> int:
    try:
        base = ledger.load(baseline_path)
        new = ledger.load(new_path)
    except (OSError, ValueError) as e:
        print(f"bench_diff: {e}", file=sys.stderr)
        return 1
    if base["suite"] != new["suite"]:
        print(f"bench_diff: suite mismatch {base['suite']!r} vs "
              f"{new['suite']!r}", file=sys.stderr)
        return 1
    d = diff_ledgers(base, new)
    out(f"== {base['suite']}: {Path(new_path).name} vs "
        f"{Path(baseline_path).name} ({len(base['runs'])} baseline runs) ==")
    for line in d["lines"]:
        out("  " + line)
    n_reg = len(d["regressions"])
    out(f"  {n_reg} regressions, {len(d['improvements'])} improvements")
    return 1 if n_reg else 0


def _self_check(out) -> int:
    """No-args mode: within each of the port's ledgers, diff the last run
    against the runs before it, a check that the history itself is
    consistent.  A one-run ledger passes; a missing one fails."""
    rc = 0
    for path in (ledger.SERVE_LEDGER, ledger.KERNEL_LEDGER):
        if not Path(path).exists():
            print(f"bench_diff: no ledger at {path}", file=sys.stderr)
            rc = 1
            continue
        try:
            led = ledger.load(path)
        except (OSError, ValueError) as e:
            print(f"bench_diff: {e}", file=sys.stderr)
            rc = 1
            continue
        if len(led["runs"]) < 2:
            out(f"== {led['suite']}: {Path(path).name} has "
                f"{len(led['runs'])} run(s); nothing to diff ==")
            continue
        prior = dict(led, runs=led["runs"][:-1])
        d = diff_ledgers(prior, led)
        out(f"== {led['suite']}: last vs prior {len(prior['runs'])} "
            f"run(s) of {Path(path).name} ==")
        for line in d["lines"]:
            out("  " + line)
        if d["regressions"]:
            rc = 1
    return rc


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="diff two bench-ledger files; exit 1 on any gated "
                    "(virtual-clock) regression")
    ap.add_argument("--baseline", default=None, metavar="LEDGER.json",
                    help="baseline ledger (e.g. BENCH_SERVE.json or "
                         "BENCH_SERVE_TORCH.json)")
    ap.add_argument("--new", default=None, metavar="LEDGER.json",
                    help="fresh ledger to compare (e.g. the candidate of "
                         "python -m repro_torch.paper.ledger)")
    ap.add_argument("--report", default=None, metavar="OUT.txt",
                    help="also write the report lines to this file")
    args = ap.parse_args(argv)
    if (args.baseline is None) != (args.new is None):
        ap.error("--baseline and --new go together (omit both for the "
                 "self-check of the port's ledgers)")

    report_lines = []

    def out(line):
        print(line)
        report_lines.append(line)

    if args.baseline is None:
        rc = _self_check(out)
    else:
        rc = _compare(args.baseline, args.new, out)
    out("RESULT: REGRESSION" if rc else "RESULT: ok")
    if args.report:
        p = Path(args.report)
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text("\n".join(report_lines) + "\n")
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
