"""Per-matrix sensitivity profiling (the planner's measurement stage) —
port of ``repro/precision/profile.py``.

Three zero-shot signals per quantizable unit, cheapest first:

1. **Blockwise quantization error** per candidate k — RMS relative error
   of the unit quantized exactly as the tree walk would store it
   (models/quantize.quantize_unit, core/qtensor.quantization_error, which
   reduces a stacked unit one item at a time).
2. **Outlier mass** — fraction of producer-std energy (core/proxy's
   hidden-unit std, the paper's Eq. 2 signal) concentrated in the top 1%
   of hidden units.  Outlier-heavy matrices degrade super-linearly in
   quantization error (§3), so the proxy degradation model up-weights
   them.
3. **Teacher-forced logit-KL probe** (optional) — quantize ONE unit at a
   probe bit-width, leave the rest 16-bit, and measure full-model KL on
   a synthetic batch.  This calibrates each unit's qerr->KL coefficient,
   replacing the heuristic size/outlier weighting with a measured one.

The predicted degradation used by the allocators is

    D(u, k) = coef_u * qerr(u, k)^2
    coef_u  = probe_kl(u, k*) / qerr(u, k*)^2        (probed)
            = n_params_u * (1 + GAMMA * outlier_mass_u)   (proxy-only)

— additive across units (independent-noise assumption, same rationale
as the paper's per-matrix scaling treatment).

Everything runs on the device the parameters are on.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

import torch

from repro_torch.configs.base import QuantConfig
from repro_torch.core import proxy
from repro_torch.core.bits import quantized_bits_per_param
from repro_torch.core.qtensor import quantization_error
from repro_torch.models.quantize import quantizable_units, quantize_tree, quantize_unit
from repro_torch.precision.metrics import teacher_forced_kl
from repro_torch.precision.plan import CANDIDATE_BITS, PrecisionPlan
from repro_torch.tree import leaves

#: proxy-model weight of the outlier-mass signal (units with all their
#: producer-std energy in the top 1% count 5x their parameter count)
GAMMA = 4.0

#: bit-width at which the optional KL probe calibrates each unit
PROBE_BITS = 4


@dataclass
class UnitProfile:
    """Sensitivity record for one quantizable unit."""

    name: str
    kind: str            # matrix | moe | lm_head | embed
    n_params: int
    shape: tuple
    qerr: dict = field(default_factory=dict)       # k -> RMS rel. error
    outlier_mass: float = 0.0
    probe_kl: dict = field(default_factory=dict)   # k -> measured KL
    probe_coef: float | None = None

    def degradation(self, k: int) -> float:
        """Predicted full-model KL contribution of quantizing this unit
        at k bits (0 at k >= 16)."""
        if k >= 16:
            return 0.0
        e2 = float(self.qerr[k]) ** 2
        if self.probe_coef is not None:
            return self.probe_coef * e2
        return self.n_params * (1.0 + GAMMA * self.outlier_mass) * e2

    def bits_cost(self, k: int, base: QuantConfig) -> float:
        """Total ideal bits of this unit at k (paper §5.2 accounting:
        k + scale_bits/B, 16-bit for kept-dense units)."""
        if k >= 16:
            return 16.0 * self.n_params
        bd = quantized_bits_per_param(
            k, base.block_size, centering=base.centering,
            outlier_pct=base.outlier_pct,
        )
        return bd.ideal_bits_per_param * self.n_params

    def summary(self) -> dict:
        return {
            "kind": self.kind,
            "n_params": self.n_params,
            "shape": list(self.shape),
            "qerr": {str(k): float(v) for k, v in self.qerr.items()},
            "outlier_mass": float(self.outlier_mass),
            "probe_kl": {str(k): float(v) for k, v in self.probe_kl.items()},
            "probe_coef": None if self.probe_coef is None else float(self.probe_coef),
        }


def _outlier_mass(w: torch.Tensor) -> float:
    """Energy share of the top-1% producer stds (proxy.hidden_unit_std
    over each stored matrix, one item at a time, averaged over stacked
    items)."""
    w2 = w.reshape((-1,) + tuple(w.shape[-2:]))
    std = torch.stack([proxy.hidden_unit_std(item) for item in w2])   # [items, out_units]
    e = std * std
    n = e.shape[-1]
    top = max(1, n // 100)
    srt = torch.sort(e, dim=-1, descending=True).values
    mass = torch.sum(srt[:, :top], -1) / (torch.sum(srt, -1) + 1e-12)
    # rescale so a flat spectrum scores 0 and total concentration scores 1
    base = top / n
    return float(torch.clamp((torch.mean(mass) - base) / (1.0 - base), 0.0, 1.0))


def _unit_qerr(kind: str, w, k: int, base: QuantConfig, outlier_idx) -> float:
    """RMS relative error at k bits, INCLUDING the base config's proxy-
    quantization outlier columns — the same layout quantize_tree stores."""
    ucfg = dataclasses.replace(base, bits=k)
    qt = quantize_unit(kind, w, ucfg, outlier_idx=outlier_idx)
    x = torch.swapaxes(w, -1, -2) if kind in ("matrix", "moe") else w
    return float(quantization_error(x, qt))


@torch.inference_mode()
def profile_units(
    params,
    cfg,
    *,
    base: QuantConfig | None = None,
    candidates=CANDIDATE_BITS,
    probe_toks=None,
    probe_bits: int = PROBE_BITS,
    log=lambda *a: None,
) -> dict[str, UnitProfile]:
    """Score every quantizable unit per candidate k.

    With ``probe_toks`` [B, S], each unit additionally gets a one-unit-
    quantized teacher-forced KL probe at ``probe_bits`` (cost: one forward
    per unit) that calibrates its qerr->KL coefficient.
    """
    base = base if base is not None else QuantConfig()
    units = quantizable_units(params, cfg, base)
    profiles: dict[str, UnitProfile] = {}
    for name, info in units.items():
        p = UnitProfile(name=name, kind=info["kind"],
                        n_params=info["n_params"], shape=info["shape"])
        # always measure at probe_bits too, so calibration works when the
        # caller narrows `candidates` past the probe width
        ks = {k for k in candidates if k < 16}
        if probe_toks is not None:
            ks.add(probe_bits)
        for k in sorted(ks):
            p.qerr[k] = _unit_qerr(info["kind"], info["w"], k, base,
                                   info["outlier_idx"])
        p.outlier_mass = _outlier_mass(info["w"])
        profiles[name] = p
        log(f"  profile {name}: n={p.n_params} outlier_mass={p.outlier_mass:.3f} "
            + " ".join(f"e{k}={p.qerr[k]:.3f}" for k in sorted(p.qerr)))
    if probe_toks is not None:
        _probe_calibrate(params, cfg, profiles, base, probe_toks,
                         probe_bits, log=log)
    return profiles


def _probe_calibrate(params, cfg, profiles, base, toks, probe_bits, *, log):
    """One-unit-at-a-time KL probes: quantize unit u at ``probe_bits``,
    keep everything else dense, measure teacher-forced KL vs the dense
    model, and set coef_u = KL / qerr^2."""
    dev = leaves(params)[0].device
    dense_default = dataclasses.asdict(dataclasses.replace(base, bits=16))
    for name, p in profiles.items():
        solo = PrecisionPlan(
            arch=cfg.name,
            default=dense_default,
            assignments={name: {"bits": int(probe_bits)}},
        )
        qp = quantize_tree(params, cfg, plan=solo, device=dev)
        kl = teacher_forced_kl(params, qp, cfg, toks)
        del qp
        p.probe_kl[probe_bits] = kl
        e2 = max(float(p.qerr[probe_bits]) ** 2, 1e-12)
        p.probe_coef = max(kl, 0.0) / e2
        log(f"  probe {name}: KL@{probe_bits}b={kl:.5f} coef={p.probe_coef:.3g}")
