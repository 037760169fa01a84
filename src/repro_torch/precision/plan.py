"""PrecisionPlan: the serializable output of the mixed-precision planner —
a copy of ``repro/precision/plan.py`` (pure Python; only the QuantConfig it
resolves to is the port's).

A plan maps quantizable-unit names (models/quantize.py tree paths, e.g.
"stack/0/mixer/wq") to per-matrix QuantConfig overrides.  Only the
fields that change quantization of a single matrix are overridable —
``bits``, ``dtype``, ``block_size``, ``centering``; ``bits >= 16`` keeps
the matrix dense.  Tree-level switches (outlier_pct, lm_head/embedding
gates, kernels) live in the plan's DEFAULT config so the planning
universe is fixed.

The JSON schema is versioned and shared with the reference: a plan saved
by either package loads in the other.  The reference's default config
carries ``use_kernel`` (its Pallas switch), which the port's QuantConfig
does not have; ``default_config`` leaves it out.  Quantization is
deterministic given (params, plan), so save -> load -> quantize reproduces
the quantized tree bit-exactly (tests/test_torch_precision.py).
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from pathlib import Path

from repro_torch.configs.base import QuantConfig

PLAN_VERSION = 1

#: per-unit QuantConfig fields a plan may override
OVERRIDABLE = ("bits", "dtype", "block_size", "centering")

#: candidate bit-widths the planner considers (paper's zero-shot range
#: plus the 16-bit keep-dense escape hatch)
CANDIDATE_BITS = (3, 4, 5, 6, 8)

#: default-config fields of the reference's QuantConfig that the port's
#: lacks: the Pallas switch, which has no meaning here
_REFERENCE_ONLY = ("use_kernel",)


def _validate_override(name: str, ov: dict) -> dict:
    if "bits" not in ov:
        raise ValueError(f"plan entry {name!r} has no 'bits'")
    bad = set(ov) - set(OVERRIDABLE)
    if bad:
        raise ValueError(f"plan entry {name!r} overrides non-overridable "
                         f"fields {sorted(bad)} (allowed: {OVERRIDABLE})")
    bits = int(ov["bits"])
    if not (2 <= bits <= 16):
        raise ValueError(f"plan entry {name!r}: bits={bits} outside [2, 16]")
    out = dict(ov, bits=bits)
    if "block_size" in out:
        out["block_size"] = int(out["block_size"])
    return out


@dataclass(frozen=True)
class PrecisionPlan:
    """Versioned per-matrix precision assignment for one architecture."""

    arch: str
    default: dict = field(default_factory=dict)     # QuantConfig field dict
    assignments: dict = field(default_factory=dict)  # unit name -> override
    meta: dict = field(default_factory=dict)         # budget, scores, signals
    version: int = PLAN_VERSION

    def __post_init__(self):
        if self.version != PLAN_VERSION:
            raise ValueError(
                f"unsupported plan version {self.version} "
                f"(this build reads version {PLAN_VERSION})"
            )
        object.__setattr__(
            self,
            "assignments",
            {k: _validate_override(k, dict(v)) for k, v in self.assignments.items()},
        )

    # -- QuantConfig resolution -----------------------------------------
    def default_config(self) -> QuantConfig:
        return QuantConfig(**{k: v for k, v in self.default.items()
                              if k not in _REFERENCE_ONLY})

    def config_for(self, unit: str, base: QuantConfig | None = None) -> QuantConfig:
        """Resolved per-unit QuantConfig (base <- plan default <- override)."""
        cfg = base if base is not None else self.default_config()
        ov = self.assignments.get(unit)
        if ov is None:
            return cfg
        return dataclasses.replace(cfg, **ov)

    def bits_for(self, unit: str) -> int:
        ov = self.assignments.get(unit)
        return int(ov["bits"]) if ov else int(self.default.get("bits", 4))

    # -- bookkeeping ----------------------------------------------------
    def describe(self) -> str:
        ks = {self.bits_for(u) for u in self.assignments}
        # a partial plan (meta lacks covers_all_units) leaves unassigned
        # units at the default bits — count those in the mix
        if not self.assignments or not self.meta.get("covers_all_units"):
            ks.add(int(self.default.get("bits", 4)))
        ks = sorted(ks)
        s = (f"mixed[{','.join(map(str, ks))}]" if len(ks) > 1
             else f"uniform k={ks[0]}")
        avg = self.meta.get("avg_bits_per_param")
        if avg is not None:
            s += f" ({avg:.2f} bits/param)"
        return s

    # -- (de)serialization ----------------------------------------------
    def to_json(self) -> str:
        return json.dumps(
            {
                "version": self.version,
                "arch": self.arch,
                "default": self.default,
                "assignments": self.assignments,
                "meta": self.meta,
            },
            indent=1,
            sort_keys=True,
            default=float,
        )

    @classmethod
    def from_json(cls, text: str) -> "PrecisionPlan":
        obj = json.loads(text)
        if not isinstance(obj, dict) or "version" not in obj:
            raise ValueError("not a PrecisionPlan JSON document")
        return cls(
            arch=obj.get("arch", ""),
            default=dict(obj.get("default", {})),
            assignments=dict(obj.get("assignments", {})),
            meta=dict(obj.get("meta", {})),
            version=int(obj["version"]),
        )

    def save(self, path) -> Path:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(self.to_json())
        return path

    @classmethod
    def load(cls, path) -> "PrecisionPlan":
        return cls.from_json(Path(path).read_text())


def uniform_plan(arch: str, bits: int, *, default: QuantConfig | None = None,
                 units=None, meta: dict | None = None) -> PrecisionPlan:
    """The uniform-k baseline expressed as a plan (same schema, same
    quantize path — so mixed-vs-uniform comparisons share all code)."""
    d = dataclasses.asdict(default) if default is not None else {}
    assignments = {u: {"bits": int(bits)} for u in (units or ())}
    return PrecisionPlan(arch=arch, default=d, assignments=assignments,
                         meta=dict(meta or {}, uniform_bits=int(bits),
                                   covers_all_units=bool(units)))
