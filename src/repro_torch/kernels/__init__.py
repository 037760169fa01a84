"""Hand-written CUDA kernels for Hopper and their wrappers — port of
``repro/kernels``: the fused k-bit dequant-GEMM (``qmatmul``) and the packed
KV-cache dequant (``kv_dequant``), each with its plain PyTorch version;
``ops`` holds the operand preparation and padding (``ops.qmatmul``), ``ref``
the oracle."""

from repro_torch.kernels.kv_dequant import KVQuantSpec, kv_spec
from repro_torch.kernels.ops import (
    fused_matmul,
    operand_from_qtensor,
    prepare_operand,
    qt_fused_eligible,
)
from repro_torch.kernels.ref import QMatmulOperand, qmatmul_ref

__all__ = [
    "KVQuantSpec",
    "QMatmulOperand",
    "fused_matmul",
    "kv_spec",
    "operand_from_qtensor",
    "prepare_operand",
    "qmatmul_ref",
    "qt_fused_eligible",
]
