"""Lint entry point for the PyTorch/CUDA port (docs/analysis_torch.md).

Runs, in order, failing on the first non-zero:

1. ``repro_torch.analysis.lint`` — the Layer-1 AST rules (RL001–RL005)
   over ``src/repro_torch`` against the committed
   ``LINT_BASELINE_TORCH.json`` (new findings, stale entries, and
   unjustified baseline entries all fail);
2. ``scripts/check_markdown_links.py``, as a subprocess — intra-repo
   markdown link integrity;
3. with ``--audit``, the Layer-2 captured-graph auditor over the Engine and
   Server grid at kv16/8/4 and the fused 4-bit Server (needs the card: it
   captures every serving step as a CUDA graph and reads the graph).

Usage::

    python scripts/lint_torch.py [--audit] [--root DIR]
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO_ROOT / "src"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="scripts/lint_torch.py",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--audit", action="store_true",
                    help="also run the Layer-2 captured-graph auditor on the card")
    ap.add_argument("--root", default=None, help="repo root override")
    args = ap.parse_args(argv)
    root = Path(args.root) if args.root else REPO_ROOT

    from repro_torch.analysis import lint as lint_mod

    print("== reprolint on the port (Layer 1: AST rules) ==", flush=True)
    rc = lint_mod.lint(root)
    if rc != 0:
        return rc

    print("== markdown link check ==", flush=True)
    rc = subprocess.run([sys.executable, str(REPO_ROOT / "scripts" / "check_markdown_links.py")],
                        cwd=root).returncode
    if rc != 0:
        return rc

    if args.audit:
        print("== captured-graph audit (Layer 2: kv16/8/4, on the card) ==", flush=True)
        from repro_torch.analysis import audit as audit_mod

        rc = audit_mod.main([])
        if rc != 0:
            return rc

    print("lint: all checks passed")
    return 0


if __name__ == "__main__":
    sys.exit(main())
