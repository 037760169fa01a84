"""Block-wise k-bit quantization (paper Eq. 1, §2.3) — port of
``repro/core/blockwise.py``.

The tensor is viewed flat, cut into blocks of B values, and each block is
normalized by its own absmax.  Encoding is a left-side ``searchsorted`` over
the f32 midpoints of the sorted codebook (the paper's "binary search").  As
in the reference, a block is normalized by its **f32** absmax and only then
is the scale stored as bf16, so codes and scale bits match the reference
exactly.

With centering (App. B) each block's mean is subtracted first and stored as
bf16 beside the scale.  ``mean_xla`` sums in the order XLA's CPU backend
does, so the means, and the codes of the centered blocks, match the
reference bit for bit on the CPU and on the card alike (``torch.mean``'s own
order differs from XLA's in the last bit of most blocks).

The absmax and the search run in ``kernels/quantize.quantize_blocks``: the
CUDA encode kernel for a CUDA tensor, its plain version for a CPU tensor,
as the reference runs its Pallas kernel on the accelerator and this module
on the CPU.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F


class BlockQuantized(NamedTuple):
    """Unpacked blockwise-quantized tensor (codes not yet bit-packed)."""

    codes: torch.Tensor             # uint8 [n_blocks, block_size]
    scales: torch.Tensor            # scale dtype (bf16) [n_blocks]
    means: Optional[torch.Tensor]   # bf16 [n_blocks] if centering else None


def pad_to_blocks(flat: torch.Tensor, block_size: int) -> torch.Tensor:
    n = flat.shape[0]
    n_blocks = -(-n // block_size)
    pad = n_blocks * block_size - n
    if pad:
        flat = F.pad(flat, (0, pad))
    return flat.reshape(n_blocks, block_size)


#: XLA's CPU tree-reduction window: a reduced dim longer than this is summed
#: in windows of this many values, then the window sums in turn
XLA_REDUCE_WINDOW = 32


def _sum_in_order(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last dim, one value after another from +0."""
    acc = torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
    for i in range(x.shape[-1]):
        acc = acc + x[..., i]
    return acc


def sum_xla(x: torch.Tensor, dim: int) -> torch.Tensor:
    """f32 sum over ``dim`` in the order of ``jnp.sum`` on XLA's CPU backend:
    while the dim is longer than XLA_REDUCE_WINDOW it is padded with zeros
    to a multiple of it (the lower half of the padding in front), cut into
    windows and each window summed in order; the last <= 32 values are then
    summed in order.  Read from XLA's optimized HLO (``reduce-window``) and
    LLVM IR (a sequential ``fadd`` chain per window)."""
    x = torch.movedim(x.to(torch.float32), dim, -1)
    w = XLA_REDUCE_WINDOW
    while x.shape[-1] > w:
        pad = -x.shape[-1] % w
        if pad:
            x = F.pad(x, (pad // 2, pad - pad // 2))
        x = _sum_in_order(x.reshape(x.shape[:-1] + (-1, w)))
    return _sum_in_order(x)


def mean_xla(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``jnp.mean`` over ``dim`` bit for bit: ``sum_xla`` times the f32
    reciprocal of the count (XLA rewrites the division so)."""
    n = x.shape[dim]
    return sum_xla(x, dim) * torch.tensor(1.0 / n, dtype=torch.float32, device=x.device)


def encode(x: torch.Tensor, codebook: torch.Tensor, block_size: int, *,
           centering: bool = False, scale_dtype=torch.bfloat16) -> BlockQuantized:
    """Quantize tensor ``x`` blockwise against a sorted codebook."""
    from repro_torch.kernels import quantize  # kernels.ops imports this module

    blocks = pad_to_blocks(x.reshape(-1).to(torch.float32), block_size)
    means = None
    if centering:
        means = mean_xla(blocks, 1)[:, None]
        blocks = blocks - means
    codes, scales = quantize.quantize_blocks(blocks, codebook)
    return BlockQuantized(
        codes=codes.to(torch.uint8),
        scales=scales.to(scale_dtype),
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


def quantize_dequantize(x: torch.Tensor, codebook: torch.Tensor, block_size: int, *,
                        centering: bool = False) -> torch.Tensor:
    """Round-trip helper: the quantization 'noise lens' used in evals."""
    q = encode(x, codebook, block_size, centering=centering)
    return decode(q, codebook, x.shape, out_dtype=x.dtype)


def encode_chunked(x: torch.Tensor, codebook: torch.Tensor, block_size: int, *,
                   chunk_blocks: int = 8192, **kw) -> BlockQuantized:
    """``encode`` over chunks of ``chunk_blocks`` blocks, one after another:
    bounds the peak memory of a very large tensor's encode.  Each block is
    encoded on its own, so the result is ``encode``'s."""
    blocks = pad_to_blocks(x.reshape(-1).to(torch.float32), block_size)
    parts = [encode(blocks[i: i + chunk_blocks], codebook, block_size, **kw)
             for i in range(0, blocks.shape[0], chunk_blocks)]
    means = None if parts[0].means is None else torch.cat([p.means for p in parts])
    return BlockQuantized(codes=torch.cat([p.codes for p in parts]),
                          scales=torch.cat([p.scales for p in parts]), means=means)
