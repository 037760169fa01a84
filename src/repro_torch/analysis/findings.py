"""Finding records, suppression comments, and the committed baseline — the
port's own copy of ``repro/analysis/findings.py`` (which imports no JAX;
the port imports nothing of ``repro``).

A finding is ``(rule, path, line, symbol, message)``.  Baseline matching
is on the *stable* triple ``(rule, path, symbol)`` — line numbers drift
with every edit, so they identify but never gate.  Every baseline entry
must carry a non-empty ``why`` (a written justification); entries that no
longer match any finding are *stale* and fail the lint, so the baseline can
only shrink or be deliberately edited.

Suppression: a ``# reprolint: disable=RL001`` comment on the flagged
line (comma-separate several IDs) silences that line.  ``disable=all``
silences every rule on the line.
"""

from __future__ import annotations

import json
import re
from dataclasses import dataclass, field
from pathlib import Path

_SUPPRESS_RE = re.compile(r"#\s*reprolint:\s*disable=([A-Za-z0-9_,\s]+)")


@dataclass(frozen=True)
class Finding:
    """One rule violation at a concrete source location."""

    rule: str  # "RL001"
    path: str  # repo-relative, posix separators
    line: int  # 1-based
    symbol: str  # stable context, e.g. "prefill_into_slot" or a name
    message: str

    @property
    def key(self) -> tuple:
        return (self.rule, self.path, self.symbol)

    def render(self) -> str:
        return f"{self.path}:{self.line}: {self.rule} [{self.symbol}] {self.message}"


def suppressed_lines(source: str) -> dict[int, set]:
    """Map 1-based line number -> set of rule IDs disabled on that line."""
    out: dict[int, set] = {}
    for i, ln in enumerate(source.splitlines(), start=1):
        m = _SUPPRESS_RE.search(ln)
        if m:
            out[i] = {tok.strip() for tok in m.group(1).split(",") if tok.strip()}
    return out


def apply_suppressions(findings, sources: dict[str, str]):
    """Drop findings whose line carries a matching disable comment."""
    kept = []
    for f in findings:
        sup = suppressed_lines(sources.get(f.path, ""))
        rules = sup.get(f.line, set())
        if f.rule in rules or "all" in rules:
            continue
        kept.append(f)
    return kept


@dataclass
class Baseline:
    """Committed grandfather list: findings here gate only on regression."""

    entries: list = field(default_factory=list)  # dicts: rule/path/symbol/why
    path: Path | None = None

    @classmethod
    def load(cls, path: Path) -> "Baseline":
        if not path.exists():
            return cls(entries=[], path=path)
        data = json.loads(path.read_text())
        return cls(entries=list(data.get("entries", [])), path=path)

    def validate(self) -> list:
        """Return error strings for malformed entries (empty ``why`` etc.)."""
        errors = []
        for i, e in enumerate(self.entries):
            missing = [k for k in ("rule", "path", "symbol") if not e.get(k)]
            if missing:
                errors.append(f"baseline entry {i}: missing {','.join(missing)}")
            if not str(e.get("why", "")).strip():
                errors.append(
                    f"baseline entry {i} ({e.get('rule')} {e.get('path')}): "
                    "empty 'why' — every grandfathered finding needs a "
                    "written justification"
                )
        return errors

    def partition(self, findings):
        """Split findings into (new, grandfathered); also return stale entries.

        Stale = baseline entries matching no current finding, which means
        the violation was fixed and the entry must be deleted.
        """
        keys = {(e.get("rule"), e.get("path"), e.get("symbol")): e for e in self.entries}
        new, old = [], []
        hit = set()
        for f in findings:
            if f.key in keys:
                old.append(f)
                hit.add(f.key)
            else:
                new.append(f)
        stale = [e for k, e in keys.items() if k not in hit]
        return new, old, stale

    def write(self, findings, why: str = "") -> None:
        assert self.path is not None
        entries = [
            {"rule": f.rule, "path": f.path, "symbol": f.symbol, "why": why}
            for f in sorted(findings, key=lambda f: f.key)
        ]
        payload = {"version": 1, "entries": entries}
        self.path.write_text(json.dumps(payload, indent=2) + "\n")
