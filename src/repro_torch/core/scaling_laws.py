"""Bit-level inference scaling-law fitting (paper §4 "Scaling laws") — a
copy of ``repro/core/scaling_laws.py`` (numpy only).

The paper found bivariate power laws fit poorly and instead represents
each precision's scaling trend as a LINEAR INTERPOLATION of metric vs
log2(total model bits); curves for different precisions are near-parallel,
so each precision is (base trend + offset).  The bit-level-optimal
precision at a bit budget is then read off the interpolated curves.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class Observation:
    """One (model, quant-config) evaluation point."""

    n_params: int
    bits_per_param: float      # paper accounting (k + 16/B + p(16-k)), 16.0 for fp16
    metric: float              # loss/perplexity (lower better) or accuracy (higher)
    precision: int             # nominal k
    tags: dict = field(default_factory=dict)

    @property
    def total_bits(self) -> float:
        return self.n_params * self.bits_per_param


@dataclass
class ScalingCurve:
    """Linear interpolation of metric vs log2(total bits) for one precision."""

    precision: int
    log2_bits: np.ndarray
    metric: np.ndarray

    def __post_init__(self):
        order = np.argsort(self.log2_bits)
        self.log2_bits = np.asarray(self.log2_bits)[order]
        self.metric = np.asarray(self.metric)[order]

    def at(self, log2_total_bits: float) -> float:
        """Interpolated metric at a bit budget (linear extrapolation at ends)."""
        x, y = self.log2_bits, self.metric
        if len(x) == 1:
            return float(y[0])
        if log2_total_bits <= x[0]:
            slope = (y[1] - y[0]) / (x[1] - x[0])
            return float(y[0] + slope * (log2_total_bits - x[0]))
        if log2_total_bits >= x[-1]:
            slope = (y[-1] - y[-2]) / (x[-1] - x[-2])
            return float(y[-1] + slope * (log2_total_bits - x[-1]))
        return float(np.interp(log2_total_bits, x, y))

    @property
    def support(self) -> tuple[float, float]:
        return float(self.log2_bits[0]), float(self.log2_bits[-1])


def fit_curves(observations: list[Observation]) -> dict[int, ScalingCurve]:
    """Group observations by precision and build interpolation curves."""
    by_prec: dict[int, list[Observation]] = {}
    for ob in observations:
        by_prec.setdefault(ob.precision, []).append(ob)
    curves = {}
    for prec, obs in sorted(by_prec.items()):
        curves[prec] = ScalingCurve(
            precision=prec,
            log2_bits=np.array([np.log2(o.total_bits) for o in obs]),
            metric=np.array([o.metric for o in obs]),
        )
    return curves


def optimal_precision(
    curves: dict[int, ScalingCurve],
    *,
    lower_is_better: bool = True,
    n_budgets: int = 33,
) -> dict:
    """Sweep bit budgets across the common support; report the winning
    precision at each budget and the overall winner (paper Fig. 1/2 logic)."""
    lo = max(c.support[0] for c in curves.values())
    hi = min(c.support[1] for c in curves.values())
    if hi <= lo:  # curves don't overlap; fall back to union support
        lo = min(c.support[0] for c in curves.values())
        hi = max(c.support[1] for c in curves.values())
    budgets = np.linspace(lo, hi, n_budgets)
    table = []
    wins: dict[int, int] = {p: 0 for p in curves}
    for b in budgets:
        vals = {p: c.at(b) for p, c in curves.items()}
        best = min(vals, key=vals.get) if lower_is_better else max(vals, key=vals.get)
        wins[best] += 1
        table.append({"log2_bits": float(b), "values": vals, "best": best})
    overall = max(wins, key=wins.get)
    return {"per_budget": table, "wins": wins, "optimal_precision": overall}


def pareto_frontier(
    observations: list[Observation], *, lower_is_better: bool = True
) -> list[Observation]:
    """Observations not dominated in (total_bits, metric)."""
    obs = sorted(observations, key=lambda o: o.total_bits)
    out: list[Observation] = []
    best = np.inf if lower_is_better else -np.inf
    for o in obs:
        better = o.metric < best if lower_is_better else o.metric > best
        if better:
            out.append(o)
            best = o.metric
    return out
