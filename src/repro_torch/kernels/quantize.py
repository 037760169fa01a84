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
launches.  It encodes the flat items (cols % B != 0, some of the sweep's)
and ``kernels/ops.prepare_operand``.

``quantize_pack`` encodes a row-structured item (cols % B == 0: every
serving weight) from the weight as stored to what the port stores, in one
launch of ``csrc/quantize_pack.cu``:

  item     [rows, cols], or [cols, rows] with ``transposed``   bf16 or f32
  packed   [rows, ceil(cols / cpw)] int32, each row from a word, zero tail
  scales   [rows, cols / B] bf16

which is what ``to_structured(quantize_tensor(...))`` stores, bit for bit.
Its plain version, ``quantize_pack_plain``, is that chain as one function;
``quantize_pack_cuda.launches`` counts the launches.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.core import packing
from repro_torch.core.blockwise import pad_to_blocks
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


def _lib_pack():
    lib = _build.load("quantize_pack")
    if not getattr(lib, "_argtypes_set", False):
        lib.quantize_pack.argtypes = ([ctypes.c_void_p] + [ctypes.c_int] * 2 + [ctypes.c_void_p]
                                      + [ctypes.c_int] + [ctypes.c_void_p] * 2
                                      + [ctypes.c_int] * 4 + [ctypes.c_void_p])
        lib.quantize_pack.restype = ctypes.c_int
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


#: warps the encode grid should reach before segments of a row get shorter
#: (16 warps an SM of an H100)
PACK_MIN_WARPS = 16 * 132
#: most columns a warp's segment takes
PACK_MAX_SEGMENT = 512


def pack_segment(rows: int, cols: int, bits: int, block_size: int) -> int:
    """Columns a warp of ``csrc/quantize_pack.cu`` takes: a multiple of
    lcm(B, cpw), so each segment starts on a block and a word; the longest
    up to PACK_MAX_SEGMENT (or one lcm) whose grid still has
    PACK_MIN_WARPS warps, else one lcm."""
    unit = math.lcm(block_size, packing.codes_per_word(bits))
    groups = -(-rows // 32)
    m = max(1, PACK_MAX_SEGMENT // unit)
    while m > 1 and groups * -(-cols // (m * unit)) < PACK_MIN_WARPS:
        m -= 1
    return m * unit


def _check_pack(item: torch.Tensor, codebook: torch.Tensor, bits: int, block_size: int,
                transposed: bool) -> tuple[int, int]:
    """(rows, cols) of the logical item, or raise for what the kernel and
    its plain version do not take."""
    if item.ndim != 2 or item.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"quantize_pack takes a 2-D bf16 or f32 item, got {item.dtype} "
                         f"{tuple(item.shape)}")
    if not item.is_contiguous():
        raise ValueError("quantize_pack takes the item as stored, contiguous (pass a "
                         "transposed view's .T with transposed=True)")
    if not 3 <= bits <= 8:
        raise ValueError(f"quantize_pack takes 3 to 8 bits, got {bits}")
    if codebook.shape != (2 ** bits,) or codebook.device != item.device:
        raise ValueError(f"quantize_pack: codebook of {2 ** bits} entries on {item.device}, "
                         f"got {tuple(codebook.shape)} on {codebook.device}")
    rows, cols = (item.shape[1], item.shape[0]) if transposed else tuple(item.shape)
    if block_size < 1 or cols % block_size:
        raise ValueError(f"quantize_pack takes row-structured items (cols % B == 0), got "
                         f"cols {cols}, B {block_size}")
    return rows, cols


def quantize_pack_plain(item: torch.Tensor, codebook: torch.Tensor, *, bits: int,
                        block_size: int, transposed: bool = False):
    """The plain version: the logical item (``item.T`` when transposed)
    encoded as ``core/blockwise.encode`` encodes it, its codes packed row by
    row.  Returns (packed int32 [rows, ceil(cols / cpw)], scales bf16 [rows,
    cols / B])."""
    rows, cols = _check_pack(item, codebook, bits, block_size, transposed)
    w = item.T if transposed else item
    codes, scales = quantize_blocks_ref(pad_to_blocks(w.reshape(-1).to(torch.float32),
                                                      block_size), codebook)
    return (packing.pack(codes.reshape(rows, cols), bits),
            scales.to(torch.bfloat16).reshape(rows, cols // block_size))


def quantize_pack_cuda(item: torch.Tensor, codebook: torch.Tensor, *, bits: int,
                       block_size: int, transposed: bool = False):
    """Launch ``csrc/quantize_pack.cu`` on a CUDA item; counts launches in
    ``.launches``."""
    rows, cols = _check_pack(item, codebook, bits, block_size, transposed)
    if item.device.type != "cuda":
        raise ValueError(f"quantize_pack_cuda takes a CUDA item, got {item.device}")
    if not transposed and item.data_ptr() % 16:
        raise ValueError("quantize_pack_cuda: a row-major item must start on 16 bytes")
    bounds = codebook_boundaries(codebook.to(torch.float32)).contiguous()
    cpw = packing.codes_per_word(bits)
    packed = torch.empty((rows, -(-cols // cpw)), dtype=torch.int32, device=item.device)
    scales = torch.empty((rows, cols // block_size), dtype=torch.bfloat16, device=item.device)
    with torch.cuda.device(item.device):
        stream = torch.cuda.current_stream(item.device).cuda_stream
        status = _lib_pack().quantize_pack(
            item.data_ptr(), int(item.dtype == torch.bfloat16), int(transposed),
            bounds.data_ptr(), bits, packed.data_ptr(), scales.data_ptr(), rows, cols,
            block_size, pack_segment(rows, cols, bits, block_size), stream)
    _build.check(status, "quantize_pack")
    quantize_pack_cuda.launches += 1
    return packed, scales


quantize_pack_cuda.launches = 0


def quantize_pack(item: torch.Tensor, codebook: torch.Tensor, *, bits: int, block_size: int,
                  transposed: bool = False):
    """Encode one row-structured item to (packed, scales) as stored: the
    CUDA kernel for a CUDA item, the plain version for a CPU item."""
    if item.device.type == "cuda":
        return quantize_pack_cuda(item, codebook, bits=bits, block_size=block_size,
                                  transposed=transposed)
    if item.device.type == "cpu":
        return quantize_pack_plain(item, codebook, bits=bits, block_size=block_size,
                                   transposed=transposed)
    raise ValueError(f"quantize_pack runs on cuda or cpu tensors, not {item.device}")
