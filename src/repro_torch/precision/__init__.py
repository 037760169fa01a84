"""Mixed-precision planning: per-matrix sensitivity profiling and bit
allocation under a total-bits budget — port of ``repro/precision`` (the
paper's open lever beyond uniform 4-bit).

    from repro_torch.precision import build_plan, PrecisionPlan, probe_tokens
    plan = build_plan(params, cfg, equal_avg_bits=4,
                      probe_toks=probe_tokens(cfg))
    qparams = quantize_tree(params, cfg, plan=plan)   # models/quantize.py
    plan.save("plan.json")                            # --plan for serving

A plan's JSON is the reference's: a plan saved by either package loads in
the other.  Profiling, the KL probes and the candidate trees run on the
device the parameters are on.
"""

from repro_torch.precision.allocate import (
    allocation_cost,
    allocation_degradation,
    greedy_allocate,
    lagrangian_allocate,
    uniform_cost,
)
from repro_torch.precision.metrics import probe_tokens, teacher_forced_kl
from repro_torch.precision.plan import CANDIDATE_BITS, PrecisionPlan, uniform_plan
from repro_torch.precision.planner import build_plan
from repro_torch.precision.profile import UnitProfile, profile_units

__all__ = [
    "CANDIDATE_BITS",
    "PrecisionPlan",
    "UnitProfile",
    "allocation_cost",
    "allocation_degradation",
    "build_plan",
    "greedy_allocate",
    "lagrangian_allocate",
    "probe_tokens",
    "profile_units",
    "teacher_forced_kl",
    "uniform_cost",
    "uniform_plan",
]
