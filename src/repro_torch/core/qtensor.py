"""QuantizedTensor: k-bit block-quantized parameters — port of
``repro/core/qtensor.py``.

A QuantizedTensor holds a logical tensor of shape ``batch_shape +
quant_shape``; each item along the batch dims (the layer axis of a stacked
weight) is block-quantized on its own:

  packed   int32  [*B, n_words]       packed codes (uint32 bits, core/packing.py)
  scales   bf16   [*B, n_blocks]      per-block absmax constants
  codebook f32    [*B, 2^k]           sorted data-type codebook, one per item

``to_structured`` turns 2-D items into row storage (packed [*B, rows,
words_per_row], scales [*B, rows, cols // block]), which is exactly the
fused dequant-GEMM operand layout.  Field names follow the reference, so a
tree flattens to the same keys (``interop.flatten``).

Not in this slice: centering means and proxy outliers.  The fields exist
(always None here) and the functions that would need them raise
NotImplementedError.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from repro_torch.core import blockwise, packing
from repro_torch.core.codebooks import make_codebook, quantile_codebook

#: data fields in the reference's order (jax flattens them in this order)
DATA_FIELDS = ("packed", "scales", "means", "codebook", "outlier_vals", "outlier_idx")


def dtype_name(dtype: torch.dtype) -> str:
    """'float32', 'bfloat16', ... — the reference's ``str(x.dtype)``."""
    return str(dtype).removeprefix("torch.")


@dataclasses.dataclass
class QuantizedTensor:
    packed: torch.Tensor
    scales: torch.Tensor
    means: Optional[torch.Tensor]
    codebook: torch.Tensor
    outlier_vals: Optional[torch.Tensor]
    outlier_idx: Optional[torch.Tensor]
    quant_shape: tuple
    bits: int
    block_size: int
    dtype_name: str
    centering: bool
    outlier_axis: int = 0
    transposed: bool = False
    structured: bool = False
    orig_dtype: str = "float32"

    @property
    def batch_shape(self) -> tuple:
        return tuple(self.packed.shape[: -2 if self.structured else -1])

    def select(self, i: int) -> "QuantizedTensor":
        """Item ``i`` of the leading batch dim (one layer of a stacked
        weight) — the port's stand-in for the reference's scan slicing."""
        if not self.batch_shape:
            raise ValueError("QuantizedTensor has no batch dim to index")
        return dataclasses.replace(self, **{
            f: None if getattr(self, f) is None else getattr(self, f)[i]
            for f in DATA_FIELDS})


def _not_in_slice(what: str):
    return NotImplementedError(
        f"{what} is not ported yet (repro_torch's first slice serves plain "
        "blockwise weights; see ROADMAP.md queue A)")


def quantize_tensor(x: torch.Tensor, *, bits: int, dtype: str = "float",
                    block_size: int = 64, batch_dims: int = 0,
                    centering: bool = False, exponent_bits: int | None = None,
                    outlier_idx: torch.Tensor | None = None, outlier_axis: int = 0,
                    transposed: bool = False,
                    scale_dtype=torch.bfloat16) -> QuantizedTensor:
    """Quantize ``x`` on its device; the leading ``batch_dims`` axes are
    quantized independently, one item at a time (the reference vmaps)."""
    if centering:
        raise _not_in_slice("centering (paper App. B)")
    if outlier_idx is not None:
        raise _not_in_slice("proxy quantization outliers (paper §3)")
    batch_shape = tuple(x.shape[:batch_dims])
    quant_shape = tuple(x.shape[batch_dims:])
    xb = x.reshape((-1,) + quant_shape)
    if dtype != "quantile":
        cb0 = make_codebook(dtype, bits, exponent_bits=exponent_bits, device=x.device)
    packed, scales, cbs = [], [], []
    for item in xb:
        cb = quantile_codebook(item, bits) if dtype == "quantile" else cb0.clone()
        q = blockwise.encode(item, cb, block_size, scale_dtype=scale_dtype)
        packed.append(packing.pack(q.codes.reshape(-1), bits))
        scales.append(q.scales)
        cbs.append(cb)

    def unbatch(parts):
        a = torch.stack(parts)
        return a.reshape(batch_shape + a.shape[1:])

    return QuantizedTensor(
        packed=unbatch(packed), scales=unbatch(scales), means=None,
        codebook=unbatch(cbs), outlier_vals=None, outlier_idx=None,
        quant_shape=quant_shape, bits=bits, block_size=block_size,
        dtype_name=dtype, centering=False, outlier_axis=outlier_axis,
        transposed=transposed, orig_dtype=dtype_name(x.dtype),
    )


def to_structured(qt: QuantizedTensor) -> QuantizedTensor:
    """Row-structured storage for 2-D items: packed [*B, rows, ceil(cols /
    cpw)], scales [*B, rows, cols // block].  Needs cols divisible by the
    block size (else the flat layout is kept).  When cols do not divide the
    packing word (3-, 5-, 6-bit), the codes are repacked so each row starts
    on a word, with an inert zero tail in its last word."""
    if qt.structured or len(qt.quant_shape) != 2:
        return qt
    rows, cols = qt.quant_shape
    cpw = packing.codes_per_word(qt.bits)
    if cols % qt.block_size:
        return qt
    b = qt.batch_shape
    if cols % cpw:
        codes = packing.unpack(qt.packed, qt.bits, rows * cols)
        packed = packing.pack(codes.reshape(b + (rows, cols)), qt.bits)
    else:
        packed = qt.packed.reshape(b + (rows, cols // cpw))
    return dataclasses.replace(
        qt, packed=packed,
        scales=qt.scales.reshape(b + (rows, cols // qt.block_size)),
        structured=True,
    )


def _dequantize_item(qt: QuantizedTensor, packed, scales, cb) -> torch.Tensor:
    """One batch item back to f32 ``quant_shape``."""
    cb = cb.to(torch.float32)
    if qt.structured:
        rows, cols = qt.quant_shape
        bs = qt.block_size
        codes = packing.unpack(packed, qt.bits, cols)              # [rows, cols]
        vals = cb[codes.long()]
        w = vals.reshape(rows, cols // bs, bs) * scales.to(torch.float32)[:, :, None]
        return w.reshape(rows, cols)
    n_blocks = scales.shape[-1]
    codes = packing.unpack(packed, qt.bits, n_blocks * qt.block_size)
    q = blockwise.BlockQuantized(codes=codes.reshape(n_blocks, qt.block_size),
                                 scales=scales, means=None)
    n = math.prod(qt.quant_shape)
    return blockwise.decode(q, cb, (n,), out_dtype=torch.float32).reshape(qt.quant_shape)


def dequantize_tensor(qt: QuantizedTensor, out_dtype=torch.bfloat16) -> torch.Tensor:
    """Full dequantization back to the logical shape."""
    if qt.means is not None or qt.outlier_idx is not None:
        raise _not_in_slice("dequantizing means or outliers")
    batch_shape = qt.batch_shape
    if not batch_shape:
        return _dequantize_item(qt, qt.packed, qt.scales, qt.codebook).to(out_dtype)
    nb = len(batch_shape)
    flat = [getattr(qt, f).reshape((-1,) + getattr(qt, f).shape[nb:])
            for f in ("packed", "scales", "codebook")]
    out = torch.stack([_dequantize_item(qt, p, s, c).to(out_dtype)
                       for p, s, c in zip(*flat)])
    return out.reshape(batch_shape + tuple(qt.quant_shape))
