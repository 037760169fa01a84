"""Bit allocation under a total-bits budget (the planner's decision stage) —
a copy of ``repro/precision/allocate.py`` (pure Python: the same profiles
give the same allocation).

Given per-unit sensitivity profiles (profile.py) and a budget in TOTAL
ideal bits over the quantizable units (paper §5.2 accounting — the
non-quantizable 16-bit remainder is a constant and cancels out of any
equal-average-bits comparison), choose one candidate k per unit
minimizing the predicted degradation sum.

Two solvers, both returning {unit: k}:

* ``greedy_allocate`` — start every unit at the cheapest candidate,
  repeatedly buy the upgrade with the best marginal gain per extra bit
  until the budget is exhausted.  Exact when the per-unit degradation-
  vs-cost curves are convex; a strong heuristic otherwise.
* ``lagrangian_allocate`` — sweep the price-of-bits multiplier: for each
  lambda pick argmin_k D(u,k) + lambda * cost(u,k) per unit
  independently, keep the best feasible sweep point.  Finds solutions
  greedy can miss on non-convex curves (e.g. a unit that should jump
  3 -> 8 directly).

Budgets are conservative: an allocation's cost never exceeds the budget
(both solvers fall back to the all-minimum assignment, which is the
cheapest point in the search space).
"""

from __future__ import annotations

from repro_torch.configs.base import QuantConfig
from repro_torch.precision.plan import CANDIDATE_BITS
from repro_torch.precision.profile import UnitProfile


def allocation_cost(profiles: dict[str, UnitProfile], alloc: dict[str, int],
                    base: QuantConfig) -> float:
    return sum(p.bits_cost(alloc[u], base) for u, p in profiles.items())


def allocation_degradation(profiles: dict[str, UnitProfile],
                           alloc: dict[str, int]) -> float:
    return sum(p.degradation(alloc[u]) for u, p in profiles.items())


def uniform_cost(profiles: dict[str, UnitProfile], k: int,
                 base: QuantConfig) -> float:
    """Budget of the uniform-k baseline — the equal-average-bits anchor."""
    return sum(p.bits_cost(k, base) for p in profiles.values())


def greedy_allocate(
    profiles: dict[str, UnitProfile],
    budget_bits: float,
    *,
    base: QuantConfig,
    candidates=CANDIDATE_BITS,
) -> dict[str, int]:
    ks = sorted(set(candidates))
    alloc = {u: ks[0] for u in profiles}
    spent = allocation_cost(profiles, alloc, base)
    # upgrade ladder per unit: index into ks
    level = {u: 0 for u in profiles}
    while True:
        best = None  # (gain_per_bit, unit, new_level, d_cost)
        for u, p in profiles.items():
            li = level[u]
            if li + 1 >= len(ks):
                continue
            k_cur, k_next = ks[li], ks[li + 1]
            d_cost = p.bits_cost(k_next, base) - p.bits_cost(k_cur, base)
            if spent + d_cost > budget_bits:
                continue
            gain = p.degradation(k_cur) - p.degradation(k_next)
            rate = gain / max(d_cost, 1e-9)
            if gain > 0 and (best is None or rate > best[0]):
                best = (rate, u, li + 1, d_cost)
        if best is None:
            return alloc
        _, u, li, d_cost = best
        level[u] = li
        alloc[u] = ks[li]
        spent += d_cost


def lagrangian_allocate(
    profiles: dict[str, UnitProfile],
    budget_bits: float,
    *,
    base: QuantConfig,
    candidates=CANDIDATE_BITS,
    n_sweep: int = 96,
) -> dict[str, int]:
    ks = sorted(set(candidates))
    best_alloc = {u: ks[0] for u in profiles}
    if allocation_cost(profiles, best_alloc, base) > budget_bits:
        return best_alloc  # infeasible budget: cheapest point, flagged upstream
    best_d = allocation_degradation(profiles, best_alloc)
    # geometric lambda sweep spanning "bits are free" to "bits are everything"
    lo, hi = 1e-15, 1e3
    for i in range(n_sweep):
        lam = lo * (hi / lo) ** (i / (n_sweep - 1))
        alloc = {
            u: min(ks, key=lambda k: p.degradation(k) + lam * p.bits_cost(k, base))
            for u, p in profiles.items()
        }
        if allocation_cost(profiles, alloc, base) > budget_bits:
            continue
        d = allocation_degradation(profiles, alloc)
        if d < best_d:
            best_d, best_alloc = d, alloc
    return best_alloc
