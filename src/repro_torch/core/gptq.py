"""GPTQ (Frantar et al., 2022), the one-shot quantization baseline — port of
``repro/core/gptq.py``.

The paper (Table 1, Figure 5) compares its zero-shot methods against GPTQ:
Optimal Brain Quantization with a per-column greedy rounding order and
Cholesky-based Hessian updates, optionally with block-wise scales (the
paper's finding: GPTQ needs blocking to be bit-level efficient).

The reference computes in numpy float64 outside any kernel; this port
computes in torch float64 on the weight's device, the same steps in the same
order (``torch.linalg`` in place of LAPACK's inverse and Cholesky).
"""

from __future__ import annotations

import torch

from repro_torch.core.codebooks import codebook_boundaries


def _nearest(codebook: torch.Tensor, bounds: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return codebook[torch.searchsorted(bounds, x.contiguous())]


@torch.no_grad()
def gptq_quantize(w: torch.Tensor, hessian: torch.Tensor, codebook, *,
                  block_size: int | None = None, percdamp: float = 0.01) -> torch.Tensor:
    """Quantize weight w [in_dim, out_dim] given Hessian H = 2 X X^T [in, in];
    returns the dequantized weight in float64 on w's device (the scaling
    study evaluates models with quantization noise applied).

    block_size: each contiguous group of ``block_size`` input rows (per
    output column) gets its own absmax scale, the paper's blocking applied
    to GPTQ; None is one scale per column.  (The reference's unused
    ``update_group`` argument is left out.)"""
    dev = w.device
    f64 = torch.float64
    w = w.to(f64).clone()
    in_dim, out_dim = w.shape
    H = torch.as_tensor(hessian, device=dev).to(f64).clone()
    codebook = torch.as_tensor(codebook, device=dev).to(f64)
    bounds = codebook_boundaries(codebook)

    # dead inputs: no signal -> weight value irrelevant, zero it
    diag = H.diagonal()
    dead = diag == 0
    diag[dead] = 1.0
    w[dead, :] = 0.0

    # dampening (GPTQ step 1)
    damp = percdamp * torch.mean(H.diagonal())
    H.diagonal().add_(damp)

    # Hinv via Cholesky of the inverse (GPTQ's numerically stable form)
    Hinv = torch.linalg.inv(H)
    hinv_chol = torch.linalg.cholesky(Hinv).T  # upper triangular, rows left to right

    bs = block_size or in_dim
    n_blocks = -(-in_dim // bs)
    Q = torch.zeros_like(w)
    W = w  # working copy, updated in place
    for b in range(n_blocks):
        lo, hi = b * bs, min((b + 1) * bs, in_dim)
        # scale frozen at block entry (zero-shot absmax, matching Eq. 1)
        scale = torch.clamp(W[lo:hi, :].abs().amax(dim=0), min=1e-12)
        err_block = torch.zeros((hi - lo, out_dim), dtype=f64, device=dev)
        for i in range(lo, hi):
            d = hinv_chol[i, i]
            q = _nearest(codebook, bounds, W[i, :] / scale) * scale
            Q[i, :] = q
            err = (W[i, :] - q) / d
            # rank-1 update of the remaining rows in this block
            if i + 1 < hi:
                W[i + 1: hi, :] -= torch.outer(hinv_chol[i, i + 1: hi], err)
            err_block[i - lo, :] = err
        # propagate the block's accumulated error to all later rows
        if hi < in_dim:
            W[hi:, :] -= hinv_chol[lo:hi, hi:].T @ err_block
    return Q


def hessian_from_inputs(x: torch.Tensor) -> torch.Tensor:
    """H = 2 X X^T / n from a calibration mini-batch x [n_samples, in_dim],
    in float64 on x's device."""
    x = x.to(torch.float64)
    return 2.0 * (x.T @ x) / x.shape[0]
