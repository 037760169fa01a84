"""Plain PyTorch oracle for the fused dequant-GEMM — port of
``repro/kernels/ref.py``.

Defines the semantics the kernel must match (up to f32 accumulation
order).  The blockwise-encode oracle (``quantize_blocks_ref``) comes with
the port of the encode kernel.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import packing


class QMatmulOperand(NamedTuple):
    """Kernel-layout quantized weight for y = x @ W, W logical [K, N].

    Blocks run along the reduction dim K (per output column).  Rows are
    packed word-aligned: for odd bit-widths the last word of each row
    carries an inert zero tail, so ``packed.shape[1] == ceil(K / cpw)``.
    ``k_dim`` is the stored (block-aligned) K; narrower activations are
    zero-padded by the callers.
    """

    packed: torch.Tensor    # int32 (uint32 bits) [N, ceil(K / cpw)]
    scales: torch.Tensor    # bf16  [N, K // block]
    codebook: torch.Tensor  # f32   [2**bits]
    bits: int
    block_size: int
    k_dim: int
    dtype_name: str = "float"


def dequantize_operand(op: QMatmulOperand, out_dtype=torch.float32) -> torch.Tensor:
    """Full dequantized W^T [N, K]."""
    codes = packing.unpack(op.packed, op.bits, op.k_dim)
    vals = op.codebook.to(torch.float32)[codes.long()]
    scales = torch.repeat_interleave(op.scales.to(torch.float32), op.block_size,
                                     dim=1)[:, : op.k_dim]
    return (vals * scales).to(out_dtype)


def qmatmul_ref(x: torch.Tensor, op: QMatmulOperand) -> torch.Tensor:
    """y = x @ W with on-the-fly dequantization; x [M, K<=k_dim] -> [M, N]."""
    K = x.shape[-1]
    if K > op.k_dim:
        raise ValueError(f"activation width {K} exceeds stored K {op.k_dim}")
    wt = dequantize_operand(op)[:, :K]
    return (x.to(torch.float32) @ wt.T).to(x.dtype)
