"""Post-training quantization of a parameter tree (the paper's zero-shot
setting) — port of ``repro/models/quantize.py`` without plans and proxy
outliers.

Every parameter matrix becomes a k-bit QuantizedTensor: attention
projections, the MLP and lm_head.  Vectors (norms, biases) stay 16-bit, and
so does the embedding by default.  Weights [..., In, Out] are stored
TRANSPOSED ([..., Out, In], ``quantize.py:52-66``) so blocks run along the
reduction dim, the fused dequant-GEMM's operand layout; lm_head [V, D] is
already (out, in).  Each matrix is encoded from the weight as stored, with
no transposed copy, by ``kernels/quantize.quantize_pack`` (one launch an
item on the card).

``bits_report`` is the paper's x-axis, total model bits.

Not in this slice: ``PrecisionPlan`` mixed precision, proxy quantization
(outlier_pct > 0) and ``quantizable_units`` (the planner's unit walk,
which comes with the planner).
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import QuantConfig
from repro_torch.core.qtensor import QuantizedTensor, dequantize_tensor, quantize_tensor
from repro_torch.device import resolve_device
from repro_torch.tree import leaves


def _quantize_matrix(w: torch.Tensor, qcfg: QuantConfig) -> QuantizedTensor:
    """w [..., In, Out] -> QT storing [..., Out, In], blocks along In; each
    item is encoded from w as stored, without a transposed copy."""
    wt = torch.swapaxes(w, -1, -2)
    return quantize_tensor(
        wt, bits=qcfg.bits, dtype=qcfg.dtype, block_size=qcfg.block_size,
        batch_dims=wt.ndim - 2, exponent_bits=qcfg.exponent_bits, transposed=True,
    )


def quantize_unit(kind: str, w: torch.Tensor, qcfg: QuantConfig) -> QuantizedTensor:
    """kind "matrix": [..., In, Out] -> transposed QT; "lm_head"/"embed":
    [V, D] is already (out, in)."""
    if kind == "matrix":
        return _quantize_matrix(w, qcfg)
    return quantize_tensor(
        w, bits=qcfg.bits, dtype=qcfg.dtype, block_size=qcfg.block_size,
        exponent_bits=qcfg.exponent_bits,
    )


def quantize_tree(params, cfg, *, qcfg: QuantConfig, device=None):
    """Params tree -> the same tree with weight matrices quantized on
    ``device`` (CUDA by default)."""
    if qcfg.centering or qcfg.outlier_pct > 0:
        raise NotImplementedError("centering and proxy outliers are not ported yet")
    dev = resolve_device(device)

    def walk(tree):
        if isinstance(tree, (list, tuple)):
            return type(tree)(walk(v) for v in tree)
        if not isinstance(tree, dict):
            return tree.to(dev) if isinstance(tree, torch.Tensor) else tree
        out = {}
        for name, val in tree.items():
            if isinstance(val, dict) and isinstance(val.get("w"), torch.Tensor) \
                    and val["w"].ndim >= 2:
                out[name] = {k: (quantize_unit("matrix", v.to(dev), qcfg) if k == "w"
                                 else walk(v)) for k, v in val.items()}
            elif name == "lm_head" and qcfg.quantize_lm_head and isinstance(val, torch.Tensor):
                out[name] = quantize_unit("lm_head", val.to(dev), qcfg)
            elif name == "embed" and qcfg.quantize_embedding and isinstance(val, torch.Tensor):
                out[name] = quantize_unit("embed", val.to(dev), qcfg)
            else:
                out[name] = walk(val)
        return out

    return walk(params)


def quantize_params(params, qcfg: QuantConfig, cfg, *, device=None):
    """Uniform quantization of a params tree (the paper's setting)."""
    return quantize_tree(params, cfg, qcfg=qcfg, device=device)


def dequantize_params(qparams):
    """A quantized tree back to dense weights in each leaf's original dtype;
    transposed matrices go back to [In, Out]."""

    def one(leaf):
        if isinstance(leaf, QuantizedTensor):
            w = dequantize_tensor(leaf, out_dtype=getattr(torch, leaf.orig_dtype))
            return torch.swapaxes(w, -1, -2) if leaf.transposed else w
        if isinstance(leaf, dict):
            return {k: one(v) for k, v in leaf.items()}
        if isinstance(leaf, (list, tuple)):
            return type(leaf)(one(v) for v in leaf)
        return leaf

    return one(qparams)


def bits_report(qparams) -> dict:
    """Total-model-bits accounting over a quantized tree (paper's x-axis)."""
    q_bits = q_stored = 0.0
    q_params = fp_params = 0
    for leaf in leaves(qparams):
        if isinstance(leaf, QuantizedTensor):
            bd = leaf.bits_breakdown()
            q_bits += bd.ideal_bits_per_param * leaf.n_params
            q_stored += bd.stored_bits_per_param * leaf.n_params
            q_params += leaf.n_params
        elif isinstance(leaf, torch.Tensor) and leaf.is_floating_point():
            fp_params += leaf.numel()
    total = q_bits + 16.0 * fp_params
    n = max(q_params + fp_params, 1)
    return {
        "quantized_params": q_params,
        "fp16_params": fp_params,
        "total_bits_ideal": total,
        "total_bits_stored": q_stored + 16.0 * fp_params,
        "avg_bits_per_param": total / n,
    }
