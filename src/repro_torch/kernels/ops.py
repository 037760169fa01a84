"""Wrappers around the kernels: the fused dequant-GEMM's operand preparation,
QuantizedTensor interop and the activations' K padding, and the blockwise
encode of a whole tensor — port of ``repro/kernels/ops.py``.

``fused_matmul`` is the one path: ``qmatmul`` pads x to the stored K and
calls ``kernels/qmatmul.qmatmul`` with the weight as stored, which launches
the CUDA kernel for CUDA tensors and runs the plain version for CPU
tensors.  Unlike the reference, neither the weight's K nor M and N are
padded here: the kernels read rows as stored and mask rows and columns.

``quantize_blocks`` ravels and pads a tensor to whole blocks and calls
``kernels/quantize.quantize_blocks``: the CUDA kernel for CUDA tensors, the
plain version for CPU tensors.

On a mesh (``models/sharding.Sharder``) a rank holds a ``Placed`` leaf: its
slice of a weight, the weight's placement and the sharder that placed it.
A column-parallel product runs on this rank's output rows and its result
is gathered over "model" (``tp_column_parallel``): B1 (``qmatmul``) for
the fused mode, the dequantized rows for the oracle mode, both with the
same split of x's rows over the data axes where they divide
(``_row_part``).  The collectives are ``torch.distributed``'s, issued
whatever the size of their group.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.core import blockwise, packing
from repro_torch.core.codebooks import make_codebook
from repro_torch.core.qtensor import QuantizedTensor
from repro_torch.kernels import qmatmul as qk
from repro_torch.kernels import quantize as quantk
from repro_torch.kernels.ref import QMatmulOperand
from repro_torch.utils import cost


def prepare_operand(w: torch.Tensor, *, bits: int, dtype: str = "float",
                    block_size: int = 64, exponent_bits=None) -> QMatmulOperand:
    """Quantize a dense weight [K, N] into kernel layout (blocks along K),
    on w's device.  K is zero-padded to block alignment; each row packs
    word-aligned with an inert tail for odd bit-widths."""
    K, N = w.shape
    # a quantile codebook must see the real weights, not the padding
    cb = make_codebook(dtype, bits, exponent_bits=exponent_bits, tensor=w)
    Kb = -(-K // block_size) * block_size
    if Kb != K:
        w = F.pad(w, (0, 0, 0, Kb - K))
    q = blockwise.encode(w.T, cb, block_size)
    codes = q.codes.reshape(N, Kb)
    return QMatmulOperand(
        packed=packing.pack(codes, bits),
        scales=q.scales.reshape(N, Kb // block_size),
        codebook=cb.clone(), bits=bits, block_size=block_size, k_dim=Kb,
        dtype_name=dtype,
    )


def qt_fused_eligible(qt) -> bool:
    """Can this QuantizedTensor be a fused-GEMM operand?  Row-structured
    2-D storage, no batch dims left, no means, no outliers."""
    return (
        isinstance(qt, QuantizedTensor)
        and qt.structured
        and len(qt.quant_shape) == 2
        and qt.packed.ndim == 2
        and qt.means is None
        and qt.outlier_idx is None
    )


def operand_from_qtensor(qt: QuantizedTensor) -> QMatmulOperand:
    """View a 2-D QuantizedTensor storing [N, K] as kernel operands."""
    if len(qt.quant_shape) != 2:
        raise ValueError("need [N, K] storage")
    N, K = qt.quant_shape
    cpw = packing.codes_per_word(qt.bits)
    if qt.structured:
        if qt.packed.ndim != 2:
            raise ValueError("batched QuantizedTensor: select one item first")
        packed, scales = qt.packed, qt.scales
    else:
        if K % cpw or K % qt.block_size:
            raise ValueError("flat storage must align to the packing word and blocks")
        packed = qt.packed.reshape(N, K // cpw)
        scales = qt.scales.reshape(N, K // qt.block_size)
    return QMatmulOperand(packed=packed, scales=scales, codebook=qt.codebook,
                          bits=qt.bits, block_size=qt.block_size, k_dim=K,
                          dtype_name=qt.dtype_name)


def _pad_x_to_k(x2: torch.Tensor, k_dim: int) -> torch.Tensor:
    K = x2.shape[-1]
    if K > k_dim:
        raise ValueError(f"activation width {K} exceeds stored K {k_dim}")
    return F.pad(x2, (0, k_dim - K)) if K < k_dim else x2


def pad_for_kernel(x2: torch.Tensor, op: QMatmulOperand):
    """The kernel inputs for x2 [M, K<=k_dim] and ``op``: x zero-padded to
    ``k_dim`` (whole scale blocks), contiguous and on a 16-byte boundary,
    and the packed words and scales as stored.  Returns (x, packed,
    scales)."""
    x2 = _pad_x_to_k(x2, op.k_dim).contiguous()
    if x2.data_ptr() % 16:
        x2 = x2.clone()
    return x2, op.packed.contiguous(), op.scales.contiguous()


def qmatmul_work(x: torch.Tensor, op: QMatmulOperand) -> dict:
    """B1's charge: 2·M·N·K over x's own K (the padding is no work) and the
    bytes of the words and scales as stored, x and y."""
    K = x.shape[-1]
    M, N = x.numel() // K, op.packed.shape[0]
    dot = 2 * M * N * K
    return dict(flops=dot, dot_flops=dot,
                hbm_bytes=cost.nbytes(op.packed) + cost.nbytes(op.scales)
                + cost.nbytes(op.codebook) + cost.nbytes(x) + M * N * x.element_size())


@cost.unit(qmatmul_work)
def qmatmul(x: torch.Tensor, op: QMatmulOperand) -> torch.Tensor:
    """y = x @ W through the fused kernel, x [..., K<=k_dim] -> [..., N]."""
    lead = x.shape[:-1]
    xp, packed, scales = pad_for_kernel(x.reshape(-1, x.shape[-1]), op)
    y = qk.qmatmul(xp, packed, scales, op.codebook, bits=op.bits,
                   block_size=op.block_size)
    return y.reshape(lead + (packed.shape[0],))


def fused_matmul(x: torch.Tensor, op: QMatmulOperand) -> torch.Tensor:
    """Fused dequant-GEMM: x [..., K<=k_dim] -> [..., N] in x's dtype."""
    return qmatmul(x, op)


# --------------------------------------------------------------------------
# tensor-parallel products (models/sharding.Sharder)
# --------------------------------------------------------------------------

class Placed(NamedTuple):
    """A parameter leaf of which this rank holds a slice: ``local`` (a
    tensor, or a QuantizedTensor sliced on its output rows), ``spec``, the
    whole leaf's placement, one entry a dimension (an axis name, a tuple of
    them, or None; for a QuantizedTensor its packed words'), and
    ``sharder``, the Sharder that placed it (its groups and this rank's
    coordinates: ``group(axes)``, ``coord(axes)``, ``tp``, ``dp_axes``)."""

    local: object
    spec: tuple
    sharder: object

    def select(self, i: int) -> "Placed":
        """Item ``i`` of the leading (stacked layer) axis."""
        local = self.local.select(i) if isinstance(self.local, QuantizedTensor) else self.local[i]
        return Placed(local, self.spec[1:], self.sharder)

    def split_on(self, axis: str, dim: int) -> bool:
        """Whether dimension ``dim`` is split over ``axis``."""
        return axis in axis_names(self.spec[dim])


def axis_names(entry) -> tuple:
    """A spec entry as a tuple of axis names."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _row_part(sharder, m_rows: int):
    """The data axes x's rows [M, K] split over: the sharder's, when their
    size is above 1 and divides M (each rank then computes its batch
    slice), else None.  A row's reduction is untouched either way, so this
    is a choice of work and traffic shared by both matmul modes."""
    if sharder.dp_axes:
        size = sharder.coord(sharder.dp_axes)[1]
        if size > 1 and m_rows % size == 0:
            return sharder.dp_axes
    return None


def gather_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Every rank's ``x`` of ``group`` concatenated along ``dim`` in group
    rank order: one all-gather."""
    import torch.distributed as dist

    n = dist.get_world_size(group)
    xt = x.movedim(dim, 0).contiguous()
    out = torch.empty((n * xt.shape[0],) + tuple(xt.shape[1:]), dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, xt, group=group)
    return out.movedim(0, dim)


def all_reduce(x: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """x reduced in place over ``group`` ("sum" or "max"); returns x."""
    import torch.distributed as dist

    dist.all_reduce(x, op=dist.ReduceOp.MAX if op == "max" else dist.ReduceOp.SUM,
                    group=group)
    return x


def tp_column_parallel(x: torch.Tensor, local_product, sharder, bias=None) -> torch.Tensor:
    """x [..., K] -> [..., N] where ``local_product`` maps rows [m, K] to
    this rank's N / tp output columns of a weight ``sharder`` placed: x's
    rows split over the data axes where they divide, the local columns
    (plus this rank's ``bias`` slice) computed, and one all-gather over the
    axes involved puts [M, N] together on every rank.  B1 (``qmatmul``)
    and the dequantized rows take the same split, so fused = dequant stays
    token-identical on a mesh."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    M = x2.shape[0]
    rows = _row_part(sharder, M)
    axes = (rows or ()) + (sharder.tp,)
    r_idx, r_n = sharder.coord(rows or ())
    xl = x2[r_idx * (M // r_n):(r_idx + 1) * (M // r_n)] if rows else x2
    y = local_product(xl)
    if bias is not None:
        y = y + bias.to(y.dtype)
    g = gather_dim(y[None], 0, sharder.group(axes))   # [r_n * tp, m, n]
    n = y.shape[-1]
    y = g.reshape(r_n, -1, y.shape[0], n).permute(0, 2, 1, 3).reshape(M, -1)
    return y.reshape(lead + (y.shape[-1],))


def quantize_blocks(x: torch.Tensor, codebook: torch.Tensor, block_size: int):
    """Blockwise encode of a flat tensor -> (codes int32 [n_blocks, B],
    scales f32 [n_blocks]); the tail is zero-padded to a whole block."""
    xb = blockwise.pad_to_blocks(x.reshape(-1).to(torch.float32), block_size)
    return quantk.quantize_blocks(xb, codebook)
