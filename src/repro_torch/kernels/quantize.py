"""Blockwise absmax encode — port of ``repro/kernels/quantize.py``.

Replaces the TPU kernel ``quantize_blocks_pallas``
(src/repro/kernels/quantize.py:33) with hand-written CUDA for Hopper,
``csrc/quantize.cu``:

  x_blocks [n_blocks, B]    f32 blocks (``kernels/ops.quantize_blocks`` pads)
  codebook [2**k]           f32 sorted codebook, k <= 8
  codes    [n_blocks, B]    int32, #{midpoint bounds < x / scale}
  scales   [n_blocks]       f32, max(absmax, 1e-12)

The bounds are the codebook's f32 midpoints, computed here exactly as
``core/codebooks.codebook_boundaries`` computes them, so the kernel and the
plain version (``kernels/ref.quantize_blocks_ref``, a left searchsorted)
agree bit for bit.  What bounds the kernel (bytes) and its design are
noted in its source.

``quantize_blocks`` launches the kernel for CUDA tensors and runs the plain
version for CPU tensors; ``quantize_blocks_cuda.launches`` counts the
launches.  It is the encode engine of every weight quantization the port
does (``core/blockwise.encode``).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.codebooks import codebook_boundaries
from repro_torch.kernels import _build
from repro_torch.kernels.ref import quantize_blocks_ref

#: the plain PyTorch version of the kernel: the oracle itself
quantize_blocks_plain = quantize_blocks_ref


def _lib():
    lib = _build.load("quantize")
    if not getattr(lib, "_argtypes_set", False):
        lib.quantize_blocks.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong]
                                        + [ctypes.c_int] * 2 + [ctypes.c_void_p])
        lib.quantize_blocks.restype = ctypes.c_int
        lib._argtypes_set = True
    return lib


def quantize_blocks_cuda(x_blocks: torch.Tensor, codebook: torch.Tensor):
    """Launch the kernel on CUDA tensors: x_blocks f32 [n_blocks, B] ->
    (codes int32 [n_blocks, B], scales f32 [n_blocks])."""
    if x_blocks.dtype != torch.float32 or x_blocks.ndim != 2 or not x_blocks.is_contiguous():
        raise ValueError(f"quantize kernel takes contiguous f32 [n_blocks, B] blocks, got "
                         f"{x_blocks.dtype} {tuple(x_blocks.shape)}")
    if codebook.ndim != 1 or not 2 <= codebook.numel() <= 256:
        raise ValueError(f"quantize kernel takes a codebook of 2..256 entries, got "
                         f"{tuple(codebook.shape)}")
    if codebook.device != x_blocks.device:
        raise ValueError(f"quantize kernel: codebook on {codebook.device}, x on "
                         f"{x_blocks.device}")
    n_blocks, B = x_blocks.shape
    bounds = codebook_boundaries(codebook.to(torch.float32)).contiguous()
    codes = torch.empty((n_blocks, B), dtype=torch.int32, device=x_blocks.device)
    scales = torch.empty((n_blocks,), dtype=torch.float32, device=x_blocks.device)
    with torch.cuda.device(x_blocks.device):
        stream = torch.cuda.current_stream(x_blocks.device).cuda_stream
        status = _lib().quantize_blocks(x_blocks.data_ptr(), bounds.data_ptr(),
                                        codes.data_ptr(), scales.data_ptr(),
                                        n_blocks, B, bounds.numel(), stream)
    _build.check(status, "quantize_blocks")
    quantize_blocks_cuda.launches += 1
    return codes, scales


quantize_blocks_cuda.launches = 0


def quantize_blocks(x_blocks: torch.Tensor, codebook: torch.Tensor):
    """Encode whole blocks: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors."""
    if x_blocks.device.type == "cuda":
        return quantize_blocks_cuda(x_blocks, codebook)
    if x_blocks.device.type == "cpu":
        return quantize_blocks_plain(x_blocks, codebook)
    raise ValueError(f"quantize_blocks runs on cuda or cpu tensors, not {x_blocks.device}")
