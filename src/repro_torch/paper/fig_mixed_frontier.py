"""Mixed-vs-uniform precision Pareto frontier (beyond the paper's §7) — port
of ``benchmarks/fig_mixed_frontier.py``.

The paper fixes ONE k for every matrix and finds 4-bit optimal; its
"Outlook" names finer-grained precision assignment as the open lever on
the bit-level frontier.  This suite runs the precision/ planner and
places mixed plans on the SAME metric-vs-log2(total bits) axes as
Figures 2/3 (core/scaling_laws Observations, precision = MIXED):

* frontier — trained tiny ladder: uniform k in {3,4,5,6,8} perplexity
  points plus planner plans at equal-average-bits budgets anchored at
  k in {3,4,5}; fit interpolation curves, report where mixed sits.
* gate — registry archs at random init: at the uniform-4 budget the
  planner's plan must achieve teacher-forced logit KL <= the uniform-4
  baseline on the probe batch.  The planner selects by measured KL with
  uniform in the candidate set, so a FAILED row here means the
  planning/quantize path broke, not a noisy flake.

The gate runs an attention and an SSM family, as the reference does
(h2o-danube-3-4b and mamba2-130m at ``reduced()`` shapes).  Each gate row
names the arch it ran.

``run_plan`` is the fast suite ("plan" in paper/run.py): build and save
plans for the gate archs and tiny-2.6m under artifacts/plans/ (the
reference's path; a plan saved by either package serves in the other), so
that
``python -m repro_torch.launch.serve --arch tiny-2.6m --plan
artifacts/plans/tiny-2.6m.json`` works out of the box.  Everything runs on
the device of the ladder (figmix) or on ``device`` (plan; CUDA by
default).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.configs import QuantConfig
from repro_torch.configs.registry import get_arch
from repro_torch.core import scaling_laws as sl
from repro_torch.device import resolve_device
from repro_torch.models import lm
from repro_torch.models.quantize import bits_report, quantize_tree
from repro_torch.paper import common
from repro_torch.precision import (
    PrecisionPlan,
    build_plan,
    probe_tokens,
    profile_units,
    teacher_forced_kl,
    uniform_plan,
)
from repro_torch.serving import perplexity
from repro_torch.tree import leaves

#: Observation.precision sentinel for planner-mixed points (fit_curves
#: groups by this int; -1 sorts before every real k)
MIXED = -1

UNIFORM_KS = [3, 4, 5, 6, 8]
MIXED_ANCHORS = [3, 4, 5]

#: the acceptance-gate archs: one attention family, one SSM family (run at
#: reduced() shapes, as every registry arch but the tiny ladder)
GATE_ARCHS = ["h2o-danube-3-4b", "mamba2-130m"]

BASE = QuantConfig(bits=4, dtype="float", block_size=64)


def _arch(name: str):
    cfg = get_arch(name)
    return cfg if name.startswith("tiny") else cfg.reduced()


def _gate_one(arch_name: str, log, device) -> tuple[list, dict]:
    cfg = _arch(arch_name)
    params = lm.init_params(cfg, seed=0, device=device)
    toks = probe_tokens(cfg, n_seqs=4, seq_len=64, device=device)
    profiles = profile_units(params, cfg, base=BASE, probe_toks=toks, log=log)
    plan = build_plan(params, cfg, base=BASE, equal_avg_bits=4,
                      probe_toks=toks, profiles=profiles, log=log)

    qp_mixed = quantize_tree(params, cfg, plan=plan, device=device)
    qp_uni = quantize_tree(params, cfg, plan=uniform_plan(
        cfg.name, 4, default=BASE, units=profiles), device=device)
    kl_mixed = teacher_forced_kl(params, qp_mixed, cfg, toks)
    kl_uni = teacher_forced_kl(params, qp_uni, cfg, toks)
    # held-out batch: honesty check, reported but not gated (near-ties
    # between probe-selected candidates can flip on fresh data)
    held = probe_tokens(cfg, n_seqs=4, seq_len=64, seed=99, device=device)
    kl_mixed_h = teacher_forced_kl(params, qp_mixed, cfg, held)
    kl_uni_h = teacher_forced_kl(params, qp_uni, cfg, held)

    bits_mixed = bits_report(qp_mixed)["avg_bits_per_param"]
    bits_uni = bits_report(qp_uni)["avg_bits_per_param"]
    ok = (kl_mixed <= kl_uni + 1e-9) and (bits_mixed <= bits_uni + 1e-9)
    log(f"gate {cfg.name}: mixed KL={kl_mixed:.5f} ({bits_mixed:.2f} b/p) "
        f"vs uniform4 KL={kl_uni:.5f} ({bits_uni:.2f} b/p) "
        f"held-out {kl_mixed_h:.5f}/{kl_uni_h:.5f} -> "
        f"{'OK' if ok else 'FAILED'}")
    row = (f"figmix/gate/{cfg.name}", 0.0,
           f"mixed_kl={kl_mixed:.5f};uniform4_kl={kl_uni:.5f};"
           f"ok={int(ok)}")
    res = {
        "arch": cfg.name, "ok": bool(ok),
        "kl_mixed": kl_mixed, "kl_uniform4": kl_uni,
        "kl_mixed_heldout": kl_mixed_h, "kl_uniform4_heldout": kl_uni_h,
        "avg_bits_mixed": bits_mixed, "avg_bits_uniform4": bits_uni,
        "plan": {"assignments": plan.assignments,
                 "winner": plan.meta.get("winner"),
                 "bits_histogram": plan.meta.get("bits_histogram")},
    }
    assert ok, (
        f"mixed-precision gate failed on {cfg.name}: "
        f"KL {kl_mixed:.5f} vs uniform-4 {kl_uni:.5f} at "
        f"{bits_mixed:.3f} vs {bits_uni:.3f} bits/param"
    )
    return [row], res


def _frontier_model(name, cfg, params, log) -> tuple[list, list]:
    dev = leaves(params)[0].device
    toks_eval = common.eval_tokens(cfg, device=dev)
    probe = probe_tokens(cfg, n_seqs=4, seq_len=64, seed=3, device=dev)
    obs, rows = [], []
    uniform_ppl = {}
    for k in UNIFORM_KS:
        qcfg = dataclasses.replace(BASE, bits=k)
        ppl, bpp, total = common.evaluate_quant(cfg, params, qcfg, toks_eval)
        uniform_ppl[k] = ppl
        obs.append(sl.Observation(
            n_params=cfg.param_count(), bits_per_param=bpp,
            metric=float(np.log(ppl)), precision=k,
            tags={"model": name, "kind": "uniform"}))
        rows.append((f"figmix/{name}/uniform{k}", 0.0,
                     f"ppl={ppl:.3f};bits={total/8e6:.3f}MB"))
        log(f"  {name} uniform k={k} ppl={ppl:8.3f}")
    profiles = profile_units(params, cfg, base=BASE, probe_toks=probe,
                             log=lambda *a: None)
    dominated = 0
    for anchor in MIXED_ANCHORS:
        plan = build_plan(params, cfg, base=BASE, equal_avg_bits=anchor,
                          probe_toks=probe, profiles=profiles,
                          log=lambda *a: None)
        qp = quantize_tree(params, cfg, plan=plan, device=dev)
        rep = bits_report(qp)
        ppl = perplexity(qp, cfg, toks_eval, device=dev)
        obs.append(sl.Observation(
            n_params=cfg.param_count(),
            bits_per_param=rep["avg_bits_per_param"],
            metric=float(np.log(ppl)), precision=MIXED,
            tags={"model": name, "kind": "mixed", "anchor": anchor,
                  "winner": plan.meta.get("winner")}))
        rows.append((f"figmix/{name}/mixed@{anchor}", 0.0,
                     f"ppl={ppl:.3f};bits/param={rep['avg_bits_per_param']:.3f};"
                     f"winner={plan.meta.get('winner')}"))
        log(f"  {name} mixed@{anchor}b ppl={ppl:8.3f} "
            f"({plan.meta.get('winner')}, {plan.describe()})")
        dominated += int(ppl <= uniform_ppl[anchor] + 1e-9)
    # held-out dominance at equal budget: the planner selects by probe
    # KL, so beating uniform on EVAL perplexity is a generalization
    # result, not tautology — reported per model, gated only on the
    # registry archs above
    rows.append((f"figmix/{name}/dominance", 0.0,
                 f"mixed_beats_uniform_at_anchor={dominated}/"
                 f"{len(MIXED_ANCHORS)}"))
    log(f"  {name}: mixed <= uniform at equal anchor budget on held-out "
        f"ppl: {dominated}/{len(MIXED_ANCHORS)}")
    return rows, obs


def run(family, log=print):
    """``family``: ``common.trained_family``'s {name: Trained}; the gates
    run at random init on the ladder's device.  Returns the rows and
    {"gates", "observations"}."""
    device = leaves(next(iter(family.values())).params)[0].device
    rows, gates = [], []
    for arch in GATE_ARCHS:
        r, res = _gate_one(arch, log, device)
        rows += r
        gates.append(res)

    obs = []
    for name, t in family.items():
        r, o = _frontier_model(name, t.cfg, t.params, log)
        rows += r
        obs += o
    curves = sl.fit_curves(obs)
    mixed_wins = 0
    if MIXED in curves and len(curves) > 1 and len(family) > 1:
        # at each mixed point's budget, compare to the best uniform
        # curve — the paper's Fig. 2 cross-model comparison (needs >= 2
        # ladder sizes; single-point curves extrapolate flat and make
        # the lowest-ppl k look free at every budget)
        for x, y in zip(curves[MIXED].log2_bits, curves[MIXED].metric):
            best_u = min(c.at(x) for p, c in curves.items() if p != MIXED)
            mixed_wins += int(y <= best_u + 1e-9)
        rows.append(("figmix/frontier", 0.0,
                     f"mixed_at_or_below_uniform={mixed_wins}/"
                     f"{len(curves[MIXED].metric)}"))
        log(f"figmix: mixed points at/below the best uniform curve: "
            f"{mixed_wins}/{len(curves[MIXED].metric)}")
    common.save_json("fig_mixed_frontier", {
        "gates": gates,
        "observations": [
            {"model": o.tags.get("model"), "kind": o.tags.get("kind"),
             "precision": o.precision, "bits_per_param": o.bits_per_param,
             "total_bits": o.total_bits, "log_ppl": o.metric,
             "anchor": o.tags.get("anchor")}
            for o in obs
        ],
        "mixed_at_or_below_uniform": mixed_wins,
    })
    return rows, {"gates": gates, "observations": obs}


#: `plan` suite coverage: the gate archs and tiny-2.6m, so
#: `launch/serve.py --arch tiny-2.6m --plan artifacts/plans/tiny-2.6m.json`
#: works out of the box
PLAN_ARCHS = GATE_ARCHS + ["tiny-2.6m"]


def run_plan(log=print, device=None, cli_args=None):
    """Fast suite: build + save plans (random init, on ``device``, CUDA by
    default) — the JSON artifact and the smoke path for
    `launch/serve.py --plan`."""
    dev = resolve_device(device)
    rows = []
    out = {}
    for arch in PLAN_ARCHS:
        cfg = _arch(arch)
        params = lm.init_params(cfg, seed=0, device=dev)
        toks = probe_tokens(cfg, n_seqs=4, seq_len=64, device=dev)
        plan = build_plan(params, cfg, base=BASE, equal_avg_bits=4,
                          probe_toks=toks, log=log)
        path = common.ART / "plans" / f"{cfg.name}.json"
        plan.save(path)
        # round-trip sanity: the saved plan reproduces the tree bit-exactly
        reloaded = PrecisionPlan.load(path)
        assert reloaded == plan or reloaded.assignments == plan.assignments
        rows.append((f"plan/{arch}", 0.0,
                     f"{plan.describe().replace(',', '|')};"
                     f"winner={plan.meta.get('winner')};path={path}"))
        out[arch] = {"path": str(path),
                     "assignments": plan.assignments,
                     "avg_bits_per_param": plan.meta.get("avg_bits_per_param"),
                     "winner": plan.meta.get("winner")}
        log(f"plan {arch}: {plan.describe()} -> {path}")
    common.save_json("plan_suite", out)
    return rows, out
