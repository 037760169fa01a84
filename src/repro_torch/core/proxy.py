"""Outlier-dependent quantization through proxy quantization (paper §3,
Eq. 2) — port of ``repro/core/proxy.py``.

The std of each hidden unit's producing weights (the columns of the linear
layer that writes that hidden state) is a proxy for whether the unit carries
outlier features.  The top p% units are kept in 16-bit in every weight that
consumes the hidden state; the rest are quantized to k bits.  The cost is
p*(16-k) extra bits per parameter (§5.2).
"""

from __future__ import annotations

import torch

from repro_torch.core.blockwise import mean_xla, sum_xla


def std_xla(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Population std over ``dim`` (``jnp.std``'s ddof 0) in f32, summed in
    XLA's CPU order (``blockwise.sum_xla``) with the variance divided, not
    multiplied by a reciprocal, as ``jnp.var`` divides: the variance is
    ``jnp.var``'s bit for bit.  Its root is taken in f64 and rounded once to
    f32, which is the correctly rounded f32 root, as XLA's is; ``torch.sqrt``
    in f32 on the CPU is not, and was a last bit off on a few units."""
    x = x.to(torch.float32)
    centered = x - mean_xla(x, dim).unsqueeze(dim)
    ss = sum_xla(centered * centered, dim)
    var = ss / torch.full_like(ss, float(x.shape[dim]))
    return torch.sqrt(var.to(torch.float64)).to(torch.float32)


def hidden_unit_std(w_producer: torch.Tensor) -> torch.Tensor:
    """std over the input dim for each output unit of the producing weight:
    [h_in, h_out] -> [h_out]."""
    return std_xla(w_producer, 0)


def outlier_indices(std: torch.Tensor, pct: float) -> torch.Tensor:
    """Top-p% hidden units by producer-weight std (Eq. 2), sorted ascending."""
    h = std.shape[-1]
    k = max(1, int(round(h * pct)))
    return outlier_indices_topk(std, k)


def outlier_indices_topk(std: torch.Tensor, k: int) -> torch.Tensor:
    """The k largest units along the last axis, ties to the lower index (a
    stable sort of -std, as ``jnp.argsort``), sorted ascending; int32."""
    top = torch.argsort(-std, dim=-1, stable=True)[..., :k]
    return torch.sort(top, dim=-1).values.to(torch.int32)
