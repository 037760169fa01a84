"""k-bit block-wise quantization (Dettmers & Zettlemoyer, ICML 2023) —
port of ``repro/core``: codebooks, packing, blockwise encode/decode, bits
accounting, the QuantizedTensor container, proxy (outlier-dependent)
quantization and the GPTQ one-shot baseline."""

from repro_torch.core.bits import model_total_bits, quantized_bits_per_param
from repro_torch.core.blockwise import decode, encode, quantize_dequantize
from repro_torch.core.codebooks import DATA_TYPES, make_codebook
from repro_torch.core.qtensor import (
    QuantizedTensor,
    dequantize_tensor,
    quantization_error,
    quantize_tensor,
)

__all__ = [
    "DATA_TYPES",
    "QuantizedTensor",
    "decode",
    "dequantize_tensor",
    "encode",
    "make_codebook",
    "model_total_bits",
    "quantization_error",
    "quantize_dequantize",
    "quantize_tensor",
    "quantized_bits_per_param",
]
