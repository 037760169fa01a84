"""build_plan(): profile -> allocate -> select -> PrecisionPlan — port of
``repro/precision/planner.py``.

The planner is conservative by construction: the uniform-k baseline at
the target budget is always in the candidate set, and when a probe
batch is given the winner is chosen by MEASURED teacher-forced KL —
so the selected plan is never worse than uniform on the probe metric
(the fig_mixed_frontier.py acceptance gate).  Without a probe the
selection falls back to predicted degradation.  Candidate trees are
quantized on the device the parameters are on, one at a time.
"""

from __future__ import annotations

import dataclasses

from repro_torch.configs.base import QuantConfig
from repro_torch.models.quantize import quantize_tree
from repro_torch.precision import allocate
from repro_torch.precision.metrics import teacher_forced_kl
from repro_torch.precision.plan import CANDIDATE_BITS, PrecisionPlan
from repro_torch.precision.profile import profile_units
from repro_torch.tree import leaves


def build_plan(
    params,
    cfg,
    *,
    base: QuantConfig | None = None,
    budget_bits: float | None = None,
    equal_avg_bits: int | None = None,
    candidates=CANDIDATE_BITS,
    probe_toks=None,
    profiles=None,
    log=lambda *a: None,
) -> PrecisionPlan:
    """Plan per-matrix bit-widths for ``params`` under a total-bits budget.

    Budget: pass ``budget_bits`` (total ideal bits over quantizable units)
    or ``equal_avg_bits=k`` for "same budget as uniform k-bit" (default:
    uniform at base.bits — the paper's 4-bit recommendation).

    ``probe_toks`` [B, S] enables the logit-KL probes: per-unit coefficient
    calibration in the profiler plus measured candidate selection here.
    ``profiles`` short-circuits re-profiling when sweeping many budgets.
    """
    base = base if base is not None else QuantConfig()
    if profiles is None:
        profiles = profile_units(params, cfg, base=base, candidates=candidates,
                                 probe_toks=probe_toks, log=log)
    if budget_bits is None:
        k_anchor = equal_avg_bits if equal_avg_bits is not None else base.bits
        budget_bits = allocate.uniform_cost(profiles, k_anchor, base)

    n_unit_params = sum(p.n_params for p in profiles.values())
    candidate_allocs = {
        "greedy": allocate.greedy_allocate(
            profiles, budget_bits, base=base, candidates=candidates),
        "lagrangian": allocate.lagrangian_allocate(
            profiles, budget_bits, base=base, candidates=candidates),
    }
    # uniform fallbacks: every k whose uniform cost fits the budget
    for k in sorted(set(candidates)):
        if allocate.uniform_cost(profiles, k, base) <= budget_bits + 1e-6:
            candidate_allocs[f"uniform{k}"] = {u: k for u in profiles}

    scores = {}
    measured = {}
    for name, alloc in candidate_allocs.items():
        cost = allocate.allocation_cost(profiles, alloc, base)
        if cost > budget_bits + 1e-6:
            continue
        scores[name] = allocate.allocation_degradation(profiles, alloc)
        if probe_toks is not None:
            qp = quantize_tree(params, cfg, plan=_as_plan(cfg, base, alloc),
                               device=leaves(params)[0].device)
            measured[name] = teacher_forced_kl(params, qp, cfg, probe_toks)
            del qp
            log(f"  candidate {name}: predicted={scores[name]:.4g} "
                f"measured_kl={measured[name]:.5f} bits={cost:.3e}")
        else:
            log(f"  candidate {name}: predicted={scores[name]:.4g} "
                f"bits={cost:.3e}")
    if not scores:
        raise ValueError(
            f"budget {budget_bits:.3e} bits is below the cheapest "
            f"allocation (min candidate {min(candidates)}-bit everywhere); "
            "raise the budget or extend `candidates`"
        )
    pick_from = measured if measured else scores
    winner = min(pick_from, key=pick_from.get)
    alloc = candidate_allocs[winner]
    cost = allocate.allocation_cost(profiles, alloc, base)

    plan = _as_plan(cfg, base, alloc, meta={
        "budget_bits": float(budget_bits),
        "cost_bits": float(cost),
        "avg_bits_per_param": float(cost / max(n_unit_params, 1)),
        "winner": winner,
        "predicted": {k: float(v) for k, v in scores.items()},
        "measured_kl": {k: float(v) for k, v in measured.items()},
        "bits_histogram": _hist(alloc),
        "profiles": {u: p.summary() for u, p in profiles.items()},
    })
    log(f"plan: {winner} -> {plan.describe()} "
        f"(budget {budget_bits:.3e}, cost {cost:.3e})")
    return plan


def _as_plan(cfg, base: QuantConfig, alloc: dict[str, int],
             meta: dict | None = None) -> PrecisionPlan:
    meta = dict(meta or {})
    meta.setdefault("covers_all_units", True)  # alloc spans every unit
    return PrecisionPlan(
        arch=cfg.name,
        default=dataclasses.asdict(base),
        assignments={u: {"bits": int(k)} for u, k in alloc.items()},
        meta=meta,
    )


def _hist(alloc: dict[str, int]) -> dict:
    h: dict = {}
    for k in alloc.values():
        h[str(k)] = h.get(str(k), 0) + 1
    return h
