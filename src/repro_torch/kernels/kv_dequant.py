"""k-bit blockwise-quantized KV-cache layout: encode and dequant — port of
``repro/kernels/kv_dequant.py``.

Each cached token row holds ``feat = n_kv_heads * head_dim`` features,
chunked into blocks along that feature dim:

    packed  int32 (uint32 bits) [..., S_c, feat // cpw]
    scales  bf16                [..., S_c, feat // bs]

Blocks and words never cross tokens, so every byte of a cached token lives
in its row.  Only k in {4, 8} and the static codebooks (int, float,
dynamic) serve a streaming cache.

A decode step reads the cache through ``kernels/kv_attention``, whose
kernel dequantizes in registers inside the attention.  ``dequant_rows`` is
the standalone read: for CUDA tensors it launches the CUDA kernel
``csrc/kv_dequant.cu``, which replaces the TPU kernel
``dequant_rows_pallas`` (src/repro/kernels/kv_dequant.py:159); for CPU
tensors it runs the plain version, ``dequant_rows_ref``.  The reference
makes its kernel opt-in (``kv_use_kernel``); here a CUDA tensor always takes
the kernel.  What bounds the kernel (bytes; at decode shapes, launch
latency) and its design are noted in its source.

Not in this slice: ``gather_pages`` / ``dequant_pages`` (the paged pool).
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional

import torch

from repro_torch.core import packing
from repro_torch.core.codebooks import codebook_boundaries, make_codebook
from repro_torch.kernels import _build


class KVQuantSpec(NamedTuple):
    """Static description of a quantized KV cache."""

    bits: int
    block_size: int
    dtype_name: str = "float"


def kv_spec(cfg) -> Optional[KVQuantSpec]:
    """The cache-quantization spec an ArchConfig asks for (None = bf16)."""
    bits = getattr(cfg, "kv_bits", 16)
    if bits is None or bits >= 16:
        return None
    if bits not in (4, 8):
        raise ValueError(f"kv_bits must be 4, 8 or 16, got {bits}")
    if cfg.kv_dtype == "quantile":
        raise ValueError("quantile codebooks cannot serve a streaming KV cache")
    return KVQuantSpec(bits=bits, block_size=cfg.kv_block_size, dtype_name=cfg.kv_dtype)


def kv_layout(spec: KVQuantSpec, feat: int) -> tuple[int, int, int]:
    """(block_size, n_blocks, n_words) for a ``feat``-wide token row; the
    block is clamped to the row and reduced to the gcd if it does not divide."""
    bs = min(spec.block_size, feat)
    if feat % bs:
        bs = math.gcd(bs, feat)
    cpw = packing.codes_per_word(spec.bits)
    if feat % cpw:
        raise ValueError(f"feature dim {feat} must divide into {cpw}-code words "
                         f"(kv_bits={spec.bits})")
    return bs, feat // bs, feat // cpw


def kv_codebook(spec: KVQuantSpec, device) -> torch.Tensor:
    """Sorted static codebook for the cache's data type (f32 [2**bits])."""
    return make_codebook(spec.dtype_name, spec.bits, device=device)


def encode_rows(x: torch.Tensor, spec: KVQuantSpec):
    """Blockwise-quantize token rows x [..., feat]: returns (packed int32
    [..., n_words], scales bf16 [..., n_blocks]).  Plain PyTorch, as in the
    reference (the append-quantize of a decode step)."""
    feat = x.shape[-1]
    bs, n_blocks, _ = kv_layout(spec, feat)
    xb = x.to(torch.float32).reshape(x.shape[:-1] + (n_blocks, bs))
    scales = torch.clamp(xb.abs().amax(dim=-1), min=1e-12)
    normed = xb / scales[..., None]
    bounds = codebook_boundaries(kv_codebook(spec, x.device)).contiguous()
    codes = torch.searchsorted(bounds, normed)
    packed = packing.pack(codes.reshape(x.shape[:-1] + (feat,)), spec.bits)
    return packed, scales.to(torch.bfloat16)


def dequant_rows_ref(packed, scales, spec: KVQuantSpec, feat: int,
                     out_dtype=torch.bfloat16) -> torch.Tensor:
    """The plain version: packed [..., W] + scales [..., NB] -> [..., feat]."""
    bs, n_blocks, _ = kv_layout(spec, feat)
    codes = packing.unpack(packed, spec.bits, feat)
    vals = kv_codebook(spec, packed.device)[codes.long()]
    vals = vals.reshape(packed.shape[:-1] + (n_blocks, bs))
    vals = vals * scales[..., None].to(torch.float32)
    return vals.reshape(packed.shape[:-1] + (feat,)).to(out_dtype)


def _lib():
    lib = _build.load("kv_dequant")
    if not getattr(lib, "_argtypes_set", False):
        lib.kv_dequant.argtypes = ([ctypes.c_void_p] * 4
                                   + [ctypes.c_longlong] + [ctypes.c_int] * 4
                                   + [ctypes.c_void_p])
        lib.kv_dequant.restype = ctypes.c_int
        lib._argtypes_set = True
    return lib


def dequant_rows_cuda(packed: torch.Tensor, scales: torch.Tensor, spec: KVQuantSpec,
                      feat: int) -> torch.Tensor:
    """Launch the kernel on flattened CUDA rows: packed [R, W] int32, scales
    [R, NB] bf16 -> bf16 [R, feat].  Counts launches in ``.launches``."""
    bs, n_blocks, n_words = kv_layout(spec, feat)
    R = packed.shape[0]
    if packed.dtype != torch.int32 or scales.dtype != torch.bfloat16:
        raise TypeError("kv dequant kernel takes int32 packed words and bf16 scales")
    if packed.shape != (R, n_words) or scales.shape != (R, n_blocks):
        raise ValueError(f"kv dequant kernel: packed {tuple(packed.shape)} / scales "
                         f"{tuple(scales.shape)} do not fit feat={feat}, {spec}")
    if not (packed.is_contiguous() and scales.is_contiguous()):
        raise ValueError("kv dequant kernel takes contiguous rows")
    if scales.device != packed.device:
        raise ValueError("kv dequant kernel: packed and scales on different devices")
    codebook = kv_codebook(spec, packed.device)
    out = torch.empty((R, feat), dtype=torch.bfloat16, device=packed.device)
    with torch.cuda.device(packed.device):
        stream = torch.cuda.current_stream(packed.device).cuda_stream
        status = _lib().kv_dequant(
            packed.data_ptr(), scales.data_ptr(), codebook.data_ptr(), out.data_ptr(),
            R * n_words, n_words, n_blocks, spec.bits, bs, stream)
    _build.check(status, "kv_dequant")
    dequant_rows_cuda.launches += 1
    return out


dequant_rows_cuda.launches = 0


def dequant_rows(packed, scales, spec: KVQuantSpec, feat: int,
                 out_dtype=torch.bfloat16) -> torch.Tensor:
    """Dequantize [..., W] / [..., NB] leaves to [..., feat]: the CUDA kernel
    for CUDA tensors (bf16 out), the plain version for CPU tensors."""
    if packed.device.type == "cpu":
        return dequant_rows_ref(packed, scales, spec, feat, out_dtype=out_dtype)
    if packed.device.type != "cuda":
        raise ValueError(f"dequant_rows runs on cuda or cpu tensors, not {packed.device}")
    if out_dtype != torch.bfloat16:
        raise ValueError(f"the kv dequant kernel writes bf16, not {out_dtype}")
    lead = packed.shape[:-1]
    flat = dequant_rows_cuda(packed.reshape(-1, packed.shape[-1]),
                             scales.reshape(-1, scales.shape[-1]), spec, feat)
    return flat.reshape(lead + (feat,))


def kv_stored_bytes_per_token(spec: Optional[KVQuantSpec], feat: int,
                              cache_dtype_bytes: int = 2) -> float:
    """Device bytes one cached K *or* V token row occupies under the spec
    (scales included); the bf16 baseline when spec is None."""
    if spec is None:
        return float(feat * cache_dtype_bytes)
    bs, n_blocks, n_words = kv_layout(spec, feat)
    return float(n_words * 4 + n_blocks * 2)
