"""Total-model-bits accounting (the paper's x-axis) — port of
``repro/core/bits.py``.

Paper accounting (§5.2): bits/param = k + scale_bits/B (+ scale_bits/B with
centering) + p * (16 - k) for proxy outliers; unquantized parameters count
16 bits.  ``stored`` accounting also reflects the 32-bit word packing.
"""

from __future__ import annotations

from dataclasses import dataclass

from repro_torch.core.packing import stored_bits_per_param


@dataclass(frozen=True)
class BitsBreakdown:
    ideal_bits_per_param: float   # paper accounting
    stored_bits_per_param: float  # with word-aligned packing
    code_bits: float
    scale_bits: float
    outlier_bits: float

    def total_bits(self, n_params: int) -> float:
        return self.ideal_bits_per_param * n_params

    def total_stored_bits(self, n_params: int) -> float:
        return self.stored_bits_per_param * n_params


def quantized_bits_per_param(bits: int, block_size: int, *, scale_bits: int = 16,
                             centering: bool = False,
                             outlier_pct: float = 0.0) -> BitsBreakdown:
    scale = scale_bits / block_size
    if centering:
        scale *= 2.0
    outlier = outlier_pct * (16 - bits)
    return BitsBreakdown(
        ideal_bits_per_param=bits + scale + outlier,
        stored_bits_per_param=stored_bits_per_param(bits) + scale + outlier,
        code_bits=float(bits),
        scale_bits=scale,
        outlier_bits=outlier,
    )


def model_total_bits(n_quantized_params: int, n_fp16_params: int,
                     breakdown: BitsBreakdown, *, stored: bool = False) -> float:
    per = breakdown.stored_bits_per_param if stored else breakdown.ideal_bits_per_param
    return per * n_quantized_params + 16.0 * n_fp16_params
