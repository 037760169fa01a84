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

Under autograd (the train step on a mesh) each collective has its adjoint
in that placement, where activations are whole and the same on every rank
of a model group between operations: ``gather_dim``'s gradient is this
rank's slice, ``all_reduce``'s (a sum) passes through, ``fan_in`` all-reduces
the partial gradient of a value each rank uses a part of, and
``fsdp_gather`` (a weight stored cut over "data") reduce-scatters its
gradient over the data ranks.  Without autograd each is the plain
collective it was.  Each raw collective charges its per-rank payload to an
open cost measurement (``utils/cost.collective``, the reference's
``utils/hlo.py`` rule).
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
    scales).  A fake tensor (the dry-run's) has no storage whose address
    could be off, and is not checked."""
    x2 = _pad_x_to_k(x2, op.k_dim).contiguous()
    if not cost.is_fake(x2) and x2.data_ptr() % 16:
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
    coordinates: ``group(axes)``, ``coord(axes)``, ``tp``, ``dp_axes``).

    A train state's sharder (``Sharder.training()``, ``fsdp_storage``)
    stores dense leaves cut over "data" too (FSDP): ``gathered`` puts those
    dims back together where the leaf is used, a stacked layer item at a
    time (``select``).  A serving sharder's leaves are whole along "data"
    whatever their spec says, and ``gathered`` leaves them as they are."""

    local: object
    spec: tuple
    sharder: object

    def select(self, i: int) -> "Placed":
        """Item ``i`` of the leading (stacked layer) axis, gathered over
        "data" where the train state stores it cut (``gathered``); of an
        expert stack [n_p, E / tp, ...] (dense, or a QuantizedTensor cut on
        E), layer ``i``'s experts this rank holds."""
        local = self.local.select(i) if isinstance(self.local, QuantizedTensor) else self.local[i]
        return Placed(local, self.spec[1:], self.sharder).gathered()

    def gathered(self) -> "Placed":
        """This leaf with every dim stored cut over the FSDP axis all-gathered
        (``fsdp_gather``: its gradient reduce-scattered back), that axis
        dropped from the spec; the leaf itself where nothing is cut."""
        s = self.sharder
        fs = s.fsdp_axis if s.fsdp_storage else None
        if fs is None or not any(fs in axis_names(e) for e in self.spec):
            return self
        local, spec = self.local, list(self.spec)
        for d, entry in enumerate(self.spec):
            names = axis_names(entry)
            if fs in names:
                local = fsdp_gather(local, d, s.group(fs))
                rest = tuple(n for n in names if n != fs)
                spec[d] = None if not rest else rest[0] if len(rest) == 1 else rest
        return Placed(local, tuple(spec), s)

    def split_on(self, axis: str, dim: int) -> bool:
        """Whether dimension ``dim`` is split over ``axis``."""
        return axis in axis_names(self.spec[dim])

    def tp_split(self) -> bool:
        """Whether any dimension is split over the sharder's "model" axis."""
        return any(self.sharder.tp in axis_names(e) for e in self.spec)


def axis_names(entry) -> tuple:
    """A spec entry as a tuple of axis names."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _row_part(sharder, m_rows: int):
    """The data axes x's rows [M, K] split over: the sharder's, when their
    size is above 1 and divides M (each rank then computes its batch
    slice), else None.  A row's reduction is untouched either way, so this
    is a choice of work and traffic shared by both matmul modes.  A train
    step's batch is split over the data axes already (``batch_local``)."""
    if sharder.dp_axes and not sharder.batch_local:
        size = sharder.coord(sharder.dp_axes)[1]
        if size > 1 and m_rows % size == 0:
            return sharder.dp_axes
    return None


def _gather_raw(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    import torch.distributed as dist

    n = dist.get_world_size(group)
    xt = x.movedim(dim, 0).contiguous()
    out = torch.empty((n * xt.shape[0],) + tuple(xt.shape[1:]), dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, xt, group=group)
    cost.collective("all_gather", out)
    return out.movedim(0, dim)


def _reduce_scatter_raw(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's slice along ``dim`` of the sum of every rank's ``x``."""
    import torch.distributed as dist

    n = dist.get_world_size(group)
    xt = x.movedim(dim, 0).contiguous()
    out = torch.empty((xt.shape[0] // n,) + tuple(xt.shape[1:]), dtype=x.dtype,
                      device=x.device)
    dist.reduce_scatter_tensor(out, xt, group=group)
    cost.collective("reduce_scatter", out)
    return out.movedim(0, dim)


def _this_slice(g: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's slice of ``g`` along ``dim`` (group rank order)."""
    import torch.distributed as dist

    c = g.shape[dim] // dist.get_world_size(group)
    return g.narrow(dim, dist.get_rank(group) * c, c)


def _all_reduce_raw(x: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    import torch.distributed as dist

    dist.all_reduce(x, op=dist.ReduceOp.MAX if op == "max" else dist.ReduceOp.SUM,
                    group=group)
    cost.collective("all_reduce", x)
    return x


class _GatherDim(torch.autograd.Function):
    """All-gather of per-rank slices of a value whose gradient is the same
    on every rank of the group: the adjoint takes this rank's slice."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _gather_raw(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _this_slice(g, ctx.dim, ctx.group), None, None


class _AllReduceSum(torch.autograd.Function):
    """Sum of per-rank partials into a value the whole group then holds:
    the adjoint passes the (same on every rank) gradient through."""

    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce_raw(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _FanIn(torch.autograd.Function):
    """Identity on a value the whole group holds, where each rank then uses
    only a part of it: the adjoint sums the ranks' partial gradients."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce_raw(g.contiguous().clone(), ctx.group), None


class _FsdpGather(torch.autograd.Function):
    """All-gather of a weight stored cut over the data axis: every data rank
    uses the whole weight on its own batch slice, so the adjoint sums the
    ranks' gradients and keeps this rank's slice (a reduce-scatter)."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        # the whole leaf's own layout: a product's library call (and so its
        # summation order) depends on its operands' strides
        return _gather_raw(x, dim, group).contiguous()

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter_raw(g, ctx.dim, ctx.group), None, None


def _grad_on(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def gather_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Every rank's ``x`` of ``group`` concatenated along ``dim`` in group
    rank order: one all-gather.  Under autograd the gradient is this rank's
    slice of the upstream gradient, which the port's placement keeps the
    same on every rank of the group (activations whole between operations);
    ``torch.distributed.nn``'s all-gather would sum it over the group."""
    if _grad_on(x):
        return _GatherDim.apply(x, dim, group)
    return _gather_raw(x, dim, group)


def all_reduce(x: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """x reduced over ``group`` ("sum" or "max"): in place, returning x;
    under autograd a sum is out of place and passes its gradient through
    (a max there raises)."""
    if _grad_on(x):
        if op != "sum":
            raise NotImplementedError(f"all_reduce {op!r} has no gradient")
        return _AllReduceSum.apply(x, group)
    return _all_reduce_raw(x, group, op)


def fan_in(x: torch.Tensor, group) -> torch.Tensor:
    """x as it is, marked as the input of per-rank partial uses over
    ``group`` (a column-parallel product, a slice of heads or input rows):
    its gradient is all-reduced over the group in the backward.  Without
    autograd, x itself."""
    return _FanIn.apply(x, group) if _grad_on(x) else x


def fsdp_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """A weight stored cut over the data axis along ``dim``, whole: one
    all-gather; under autograd its gradient is reduce-scattered back over
    the group (summed over the data ranks' batch slices)."""
    if _grad_on(x):
        return _FsdpGather.apply(x, dim, group)
    return _gather_raw(x, dim, group).contiguous()


def tp_column_parallel(x: torch.Tensor, local_product, sharder, bias=None) -> torch.Tensor:
    """x [..., K] -> [..., N] where ``local_product`` maps rows [m, K] to
    this rank's N / tp output columns of a weight ``sharder`` placed: x's
    rows split over the data axes where they divide, the local columns
    (plus this rank's ``bias`` slice) computed, and one all-gather over the
    axes involved puts [M, N] together on every rank.  B1 (``qmatmul``)
    and the dequantized rows take the same split, so fused = dequant stays
    token-identical on a mesh.  Under autograd x's gradient, partial on
    each rank (this rank's columns only), is all-reduced over "model"
    (``fan_in``) and the gather hands each rank its columns' gradient."""
    lead = x.shape[:-1]
    x2 = fan_in(x.reshape(-1, x.shape[-1]), sharder.group(sharder.tp))
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
