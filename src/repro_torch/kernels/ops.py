"""Wrappers around the fused dequant-GEMM: operand preparation, QuantizedTensor
interop, and the K and word-tail padding — port of ``repro/kernels/ops.py``.

``fused_matmul`` is the one path: ``qmatmul`` pads K and calls
``kernels/qmatmul.qmatmul``, which launches the CUDA kernel for CUDA tensors
and runs the plain version for CPU tensors.  Padding copies nothing when K
is already aligned, as in every Qwen2-7B projection.  Unlike the reference,
M and N are not padded: the kernels mask rows and columns.

Not in this slice: the tensor-parallel dispatch scope (multi-GPU) and the
blockwise-encode kernel wrapper ``quantize_blocks``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.core import blockwise, packing
from repro_torch.core.codebooks import make_codebook
from repro_torch.core.qtensor import QuantizedTensor
from repro_torch.kernels import qmatmul as qk
from repro_torch.kernels.ref import QMatmulOperand


def _lcm(a: int, b: int) -> int:
    return a * b // math.gcd(a, b)


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


def _pad_cols(t: torch.Tensor, cols: int) -> torch.Tensor:
    """Zero-pad a 2-D tensor's last dim up to ``cols``; no copy when it fits."""
    return t if t.shape[1] == cols else F.pad(t, (0, cols - t.shape[1]))


def pad_for_kernel(x2: torch.Tensor, op: QMatmulOperand):
    """The kernel inputs for x2 [M, K<=k_dim] and ``op``: K padded to
    lcm(cpw, block), the packed words and scale blocks to match.  Zero words
    decode against zero scales, so the padding contributes nothing.  M and N
    stay as they are: the CUDA kernels mask rows and columns themselves (the
    reference pads them to its Pallas tiles).  x comes back contiguous and
    16-byte aligned.  Returns (x, packed, scales)."""
    x2 = _pad_x_to_k(x2, op.k_dim)
    cpw = packing.codes_per_word(op.bits)
    bk = _lcm(cpw, op.block_size)
    Kp = -(-x2.shape[1] // bk) * bk
    xp = _pad_cols(x2, Kp).contiguous()
    if xp.data_ptr() % 16:
        xp = xp.clone()
    return (xp,
            _pad_cols(op.packed, Kp // cpw).contiguous(),
            _pad_cols(op.scales, Kp // op.block_size).contiguous())


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
