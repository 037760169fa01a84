"""Block-wise k-bit quantization (paper Eq. 1, §2.3) — port of
``repro/core/blockwise.py``.

The tensor is viewed flat, cut into blocks of B values, and each block is
normalized by its own absmax.  Encoding is a left-side ``searchsorted`` over
the f32 midpoints of the sorted codebook (the paper's "binary search").  As
in the reference, a block is normalized by its **f32** absmax and only then
is the scale stored as bf16, so codes and scale bits match the reference
exactly.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.core.codebooks import codebook_boundaries


class BlockQuantized(NamedTuple):
    """Unpacked blockwise-quantized tensor (codes not yet bit-packed)."""

    codes: torch.Tensor             # uint8 [n_blocks, block_size]
    scales: torch.Tensor            # scale dtype (bf16) [n_blocks]
    means: Optional[torch.Tensor]   # bf16 [n_blocks] if centering else None


def _pad_to_blocks(flat: torch.Tensor, block_size: int) -> torch.Tensor:
    n = flat.shape[0]
    n_blocks = -(-n // block_size)
    pad = n_blocks * block_size - n
    if pad:
        flat = F.pad(flat, (0, pad))
    return flat.reshape(n_blocks, block_size)


def encode(x: torch.Tensor, codebook: torch.Tensor, block_size: int, *,
           centering: bool = False, scale_dtype=torch.bfloat16) -> BlockQuantized:
    """Quantize tensor ``x`` blockwise against a sorted codebook."""
    blocks = _pad_to_blocks(x.reshape(-1).to(torch.float32), block_size)
    means = None
    if centering:
        means = blocks.mean(dim=1, keepdim=True)
        blocks = blocks - means
    scales = torch.clamp(blocks.abs().amax(dim=1, keepdim=True), min=1e-12)
    normed = blocks / scales
    bounds = codebook_boundaries(codebook.to(torch.float32)).contiguous()
    codes = torch.searchsorted(bounds, normed).to(torch.uint8)
    return BlockQuantized(
        codes=codes,
        scales=scales[:, 0].to(scale_dtype),
        means=None if means is None else means[:, 0].to(scale_dtype),
    )


def decode(q: BlockQuantized, codebook: torch.Tensor, shape, *,
           out_dtype=torch.bfloat16) -> torch.Tensor:
    """Dequantize back to ``shape`` (inverse of encode up to quantization error)."""
    vals = codebook.to(torch.float32)[q.codes.long()]
    vals = vals * q.scales[:, None].to(torch.float32)
    if q.means is not None:
        vals = vals + q.means[:, None].to(torch.float32)
    n = 1
    for d in shape:
        n *= d
    return vals.reshape(-1)[:n].reshape(tuple(shape)).to(out_dtype)
