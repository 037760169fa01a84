"""QuantizedTensor: k-bit block-quantized parameters — port of
``repro/core/qtensor.py``.

A QuantizedTensor holds a logical tensor of shape ``batch_shape +
quant_shape``; each item along the batch dims (the layer axis of a stacked
weight) is block-quantized on its own:

  packed       int32 [*B, n_words]    packed codes (uint32 bits, core/packing.py)
  scales       bf16  [*B, n_blocks]   per-block absmax constants
  means        bf16  [*B, n_blocks]?  per-block means (centering, App. B)
  codebook     f32   [*B, 2^k]        sorted data-type codebook, one per item
  outlier_vals bf16  [*B, n_out, o]?  proxy-quantized 16-bit slices (Eq. 2)
  outlier_idx  int32 [*B, n_out]?     their indices along ``outlier_axis``

``to_structured`` turns 2-D items into row storage (packed [*B, rows,
words_per_row], scales and means [*B, rows, cols // block]), which is
exactly the fused dequant-GEMM operand layout (the GEMM takes neither means
nor outliers: ``kernels/ops.qt_fused_eligible``).  Field names follow the
reference, so a tree flattens to the same keys (``interop.flatten``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from repro_torch.core import blockwise, packing
from repro_torch.core.bits import BitsBreakdown, quantized_bits_per_param
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

    @property
    def shape(self) -> tuple:
        return self.batch_shape + tuple(self.quant_shape)

    @property
    def n_params(self) -> int:
        return math.prod(self.shape)

    def bits_breakdown(self) -> BitsBreakdown:
        outlier_pct = 0.0
        if self.outlier_idx is not None:
            outlier_pct = self.outlier_idx.shape[-1] / self.quant_shape[self.outlier_axis]
        return quantized_bits_per_param(self.bits, self.block_size, centering=self.centering,
                                        outlier_pct=outlier_pct)

    def select(self, i: int) -> "QuantizedTensor":
        """Item ``i`` of the leading batch dim (one layer of a stacked
        weight; on a layer's expert stack, one expert), as views — the
        port's stand-in for the reference's scan slicing."""
        if not self.batch_shape:
            raise ValueError("QuantizedTensor has no batch dim to index")
        return dataclasses.replace(self, **{
            f: None if getattr(self, f) is None else getattr(self, f)[i]
            for f in DATA_FIELDS})


def _as_stored(item: torch.Tensor) -> tuple[torch.Tensor, bool]:
    """A 2-D item as ``kernels/quantize.quantize_pack`` reads it: itself if
    contiguous, its transpose (flagged) if that is, else a contiguous copy;
    bf16 and f32 as they are, other types as f32."""
    if item.dtype not in (torch.bfloat16, torch.float32):
        item = item.to(torch.float32)
    if item.is_contiguous():
        return item, False
    if item.T.is_contiguous():
        return item.T, True
    return item.contiguous(), False


def quantize_tensor(x: torch.Tensor, *, bits: int, dtype: str = "float",
                    block_size: int = 64, batch_dims: int = 0,
                    centering: bool = False, exponent_bits: int | None = None,
                    outlier_idx: torch.Tensor | None = None, outlier_axis: int = 0,
                    transposed: bool = False,
                    scale_dtype=torch.bfloat16) -> QuantizedTensor:
    """Quantize ``x`` on its device; the leading ``batch_dims`` axes are
    quantized independently, one item at a time (the reference vmaps).

    2-D items whose rows hold whole blocks (with bf16 scales) come back in
    ``to_structured``'s row storage, encoded straight from the weight as
    stored (a transposed view is read through its transpose) by
    ``kernels/quantize.quantize_pack``: one kernel launch an item on the
    card.  Other items keep the flat layout, through the encode kernel and
    ``packing.pack``; ``to_structured`` has nothing left to do for either.

    ``centering`` (App. B) sends every item through ``blockwise.encode``,
    which subtracts each block's mean in torch before the encode kernel;
    2-D items of whole-block rows are then restructured, as the reference
    encodes flat and restructures.  ``outlier_idx`` (proxy quantization):
    per-item indices into quant axis ``outlier_axis`` (0 = rows, -1 = the
    last axis, the reduction dim of a transposed-stored weight); those
    slices are kept in bf16 and zeroed, on a copy, before the encode so they
    cannot pollute the absmax scales."""
    from repro_torch.kernels import quantize  # kernels.ops imports this module

    batch_shape = tuple(x.shape[:batch_dims])
    quant_shape = tuple(x.shape[batch_dims:])
    rows_of_blocks = (len(quant_shape) == 2 and scale_dtype == torch.bfloat16
                      and quant_shape[1] % block_size == 0)
    xb = x.reshape((-1,) + quant_shape)
    ax = outlier_axis % len(quant_shape)
    oidx = None
    if outlier_idx is not None:
        oidx = torch.as_tensor(outlier_idx, device=x.device).to(torch.int32)
        oidx = oidx.reshape(xb.shape[0], -1)
    if dtype != "quantile":
        cb0 = make_codebook(dtype, bits, exponent_bits=exponent_bits, device=x.device)
    n_items = xb.shape[0]
    out: dict = {}

    def put(field: str, i: int, t: torch.Tensor) -> None:
        # each item's result straight into the batch's storage, allocated at
        # the first item: no list of parts and no stacked copy of them (an
        # expert stack's words are 4.4 GB at moonshot-v1)
        if field not in out:
            out[field] = torch.empty((n_items,) + t.shape, dtype=t.dtype, device=t.device)
        out[field][i].copy_(t)

    for i, item in enumerate(xb):
        if oidx is not None:
            j = oidx[i].long()
            put("outlier_vals", i, item.index_select(ax, j).to(torch.bfloat16))
            item = item.index_fill(ax, j, 0.0)
        cb = quantile_codebook(item, bits) if dtype == "quantile" else cb0
        if rows_of_blocks and not centering:
            stored, flipped = _as_stored(item)
            p, s = quantize.quantize_pack(stored, cb, bits=bits, block_size=block_size,
                                          transposed=flipped)
        else:
            q = blockwise.encode(item, cb, block_size, centering=centering,
                                 scale_dtype=scale_dtype)
            # the centered path restructures rows of whole blocks: each row
            # packed from a word, scales and means one row of blocks a row
            lead = quant_shape[:1] if rows_of_blocks else ()
            p = packing.pack(q.codes.reshape(lead + (-1,)), bits)
            s = q.scales.reshape(lead + (-1,))
            if centering:
                put("means", i, q.means.reshape(lead + (-1,)))
        put("packed", i, p)
        put("scales", i, s)
        put("codebook", i, cb)

    def unbatch(field):
        a = out.get(field)
        return None if a is None else a.reshape(batch_shape + a.shape[1:])

    return QuantizedTensor(
        packed=unbatch("packed"), scales=unbatch("scales"), means=unbatch("means"),
        codebook=unbatch("codebook"), outlier_vals=unbatch("outlier_vals"),
        outlier_idx=None if oidx is None else oidx.reshape(batch_shape + oidx.shape[1:]),
        quant_shape=quant_shape, bits=bits, block_size=block_size,
        dtype_name=dtype, centering=centering, outlier_axis=outlier_axis,
        transposed=transposed, structured=rows_of_blocks, orig_dtype=dtype_name(x.dtype),
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
        means=None if qt.means is None
        else qt.means.reshape(b + (rows, cols // qt.block_size)),
        structured=True,
    )


def _dequantize_item(qt: QuantizedTensor, packed, scales, means, cb, ovals,
                     oidx) -> torch.Tensor:
    """One batch item back to f32 ``quant_shape``, outliers scattered back."""
    cb = cb.to(torch.float32)
    if qt.structured:
        rows, cols = qt.quant_shape
        bs = qt.block_size
        codes = packing.unpack(packed, qt.bits, cols)              # [rows, cols]
        vals = cb[codes.long()]
        w = vals.reshape(rows, cols // bs, bs) * scales.to(torch.float32)[:, :, None]
        if means is not None:
            w = w + means.to(torch.float32)[:, :, None]
        w = w.reshape(rows, cols)
    else:
        n_blocks = scales.shape[-1]
        codes = packing.unpack(packed, qt.bits, n_blocks * qt.block_size)
        q = blockwise.BlockQuantized(codes=codes.reshape(n_blocks, qt.block_size),
                                     scales=scales, means=means)
        n = math.prod(qt.quant_shape)
        w = blockwise.decode(q, cb, (n,), out_dtype=torch.float32).reshape(qt.quant_shape)
    if oidx is not None:
        ax = qt.outlier_axis % len(qt.quant_shape)
        w = w.index_copy(ax, oidx.long(), ovals.to(torch.float32))
    return w


def dequantize_tensor(qt: QuantizedTensor, out_dtype=torch.bfloat16) -> torch.Tensor:
    """Full dequantization back to the logical shape (outliers included)."""
    batch_shape = qt.batch_shape
    fields = ("packed", "scales", "means", "codebook", "outlier_vals", "outlier_idx")
    if not batch_shape:
        return _dequantize_item(qt, *(getattr(qt, f) for f in fields)).to(out_dtype)
    nb = len(batch_shape)
    n_items = math.prod(batch_shape)
    flat = [[None] * n_items if getattr(qt, f) is None
            else getattr(qt, f).reshape((-1,) + getattr(qt, f).shape[nb:]) for f in fields]
    out = torch.stack([_dequantize_item(qt, *a).to(out_dtype) for a in zip(*flat)])
    return out.reshape(batch_shape + tuple(qt.quant_shape))


def _sq_sums(x: torch.Tensor, qt: QuantizedTensor):
    """(sum of (dequant - x)^2, sum of x^2) in f64, one item of a stacked
    tensor at a time, so no f32 copy of a whole stack is made (a Qwen2-7B
    ``w_up`` is 1.9 G values)."""
    if qt.batch_shape:
        parts = [_sq_sums(x[i], qt.select(i)) for i in range(qt.batch_shape[0])]
        return sum(p[0] for p in parts), sum(p[1] for p in parts)
    x = x.to(torch.float32)
    d = dequantize_tensor(qt, out_dtype=torch.float32) - x
    return (d * d).sum(dtype=torch.float64), (x * x).sum(dtype=torch.float64)


def quantization_error(x: torch.Tensor, qt: QuantizedTensor) -> torch.Tensor:
    """RMS relative quantization error — used by tests, benchmarks, the
    precision planner and the load-time health snapshot.  The squares are
    summed in f64 item by item (the reference means all of them in f32),
    and the ratio is returned in f32."""
    err, ref = _sq_sums(x, qt)
    n = x.numel()
    return (torch.sqrt(err / n) / (torch.sqrt(ref / n) + 1e-12)).to(torch.float32)
