"""Fused k-bit dequantize + matmul — port of ``repro/kernels/qmatmul.py``.

Replaces the TPU kernel ``qmatmul_pallas`` (src/repro/kernels/qmatmul.py:97)
with hand-written CUDA for Hopper, ``csrc/qgemv_sm90.cu``,
``csrc/qmatmul.cu`` and ``csrc/qgemm_sm90.cu``:

  x       [M, K]        activations, f32 or bf16
  packed  [N, K//cpw]   int32 view of the uint32 words, cpw = 32 // bits
  scales  [N, K//B]     bf16 per-(column, K-block) absmax constants
  codebook[2**bits]     f32 sorted codebook
  y       [M, N]        f32 sums, written in x's dtype

The weight is rounded to x's dtype before the f32 product
(``qmatmul.py:80-85``), so this equals dequantize-then-matmul up to f32
summation order.  Every data type decodes through its codebook; for int the
table equals the TPU kernel's arithmetic ``clip(c-h, -h, h)/h`` bit for bit.

What bounds it on the card, and what the design does about it (the sources
say more): at decode (M <= 8) the packed weight bytes, so a GEMV whose
blocks split each group of columns' K among their warps streams each packed
word from device memory once and decodes it with a shared-memory table
read.  ``gemv_route`` picks the GEMV from the operands: bf16 x at 4, 7 or 8
bits with ``block_size % cpw == 0`` (the whole serving path) goes to
``csrc/qgemv_sm90.cu``, which multiplies on the tensor cores (``mma.sync``,
each packed word as its lane's A fragment); the rest (f32 x; 3, 5 and 6
bits) to the CUDA-core GEMV of ``csrc/qmatmul.cu``.  At prefill the 2*M*N*K
operations, so bf16 activations go to ``csrc/qgemm_sm90.cu``: 256 (or 128)
x 128 output tiles on Hopper's ``wgmma``, x copied as pre-laid-out tile
images by the copy engine and the packed words by ``cp.async`` into a ring
of stages, the weight dequantized into shared memory while the tensor cores
multiply the previous K step.  The wrapper allocates the tile images (``x_tiles_shape``)
and, where a grid has fewer tiles than SMs and K is split across blocks
(``split_k``), the f32 partial sums that a second, fixed-order pass adds.
f32 activations go to a tiled CUDA-core kernel in ``csrc/qmatmul.cu``.

``qmatmul`` takes the plain PyTorch version, ``qmatmul_plain``, only for
CPU tensors; for CUDA tensors it launches a kernel or raises.  Each launch
function counts its launches in a plain int, ``<function>.launches``.
Callers pad K first (``kernels/ops.qmatmul``).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core import packing
from repro_torch.kernels import _build

#: rows up to which the GEMV kernel runs (one pass over the packed weight)
GEMV_MAX_M = 8
#: bit widths of the tensor-core GEMV (csrc/qgemv_sm90.cu): whole k16 steps
#: in a packed word (8 codes at 4 bits, 4 at 7 and 8)
TC_GEMV_BITS = (4, 7, 8)
#: output tile of the tensor-core kernel by bit width (csrc/qgemm_sm90.cu
#: tile_m, BN): 256 rows where the decode leaves registers for two slabs
TILE_M = {3: 128, 4: 256, 5: 128, 6: 128, 7: 128, 8: 256}
TILE_N = 128
#: codes per K step of the tensor-core kernel, by bit width (Cfg<BITS>::KC):
#: whole packed words and whole 16-deep wgmma slices, at least 64
K_STEP = {3: 80, 4: 64, 5: 96, 6: 80, 7: 64, 8: 64}
#: fewest K steps a split of the tensor-core kernel takes
MIN_SPLIT_STEPS = 2
#: streaming multiprocessors of an H100 SXM, the split's target block count
H100_SMS = 132


def split_k(M: int, N: int, K: int, bits: int, sms: int = H100_SMS) -> int:
    """How many blocks share each output tile's K steps in the tensor-core
    kernel.  A grid with at least ``sms`` tiles is not split.  Otherwise the
    split is the smallest divisor of the K steps that brings the block count
    to ``sms``, among those leaving each block >= MIN_SPLIT_STEPS steps; if
    none does, the largest of those."""
    tiles = -(-M // TILE_M[bits]) * -(-N // TILE_N)
    steps = -(-K // K_STEP[bits])
    if tiles >= sms:
        return 1
    fits = [s for s in range(1, steps + 1)
            if steps % s == 0 and (s == 1 or steps // s >= MIN_SPLIT_STEPS)]
    return next((s for s in fits if tiles * s >= sms), fits[-1])


def split_workspace_shape(M: int, N: int, split: int):
    """The f32 partial sums a split launch needs, or None unsplit."""
    return (split, M, N) if split > 1 else None


def x_tiles_shape(M: int, K: int, bits: int):
    """The bf16 scratch for x as the tensor-core kernel's tile images: M
    padded to whole row tiles, K to whole K steps."""
    return (-(-M // TILE_M[bits]) * TILE_M[bits], -(-K // K_STEP[bits]) * K_STEP[bits])


def gemv_route(x_dtype, bits: int, block_size: int) -> str:
    """The GEMV for these operands: "tc" (tensor cores, csrc/qgemv_sm90.cu)
    for bf16 x at 4, 7 or 8 bits whose scale blocks hold whole packed words,
    else "simt" (CUDA cores, csrc/qmatmul.cu)."""
    tc = (x_dtype == torch.bfloat16 and bits in TC_GEMV_BITS
          and block_size % packing.codes_per_word(bits) == 0)
    return "tc" if tc else "simt"


def qmatmul_plain(x, packed, scales, codebook, *, bits: int,
                  block_size: int) -> torch.Tensor:
    """The plain PyTorch version of the kernel, on any device."""
    N = packed.shape[0]
    K = x.shape[1]
    codes = packing.unpack(packed, bits, K)                         # [N, K]
    vals = codebook.to(torch.float32)[codes.long()]
    w = vals.reshape(N, K // block_size, block_size) * scales.to(torch.float32)[:, :, None]
    w = w.reshape(N, K)
    if x.dtype != torch.float32:
        w = w.to(x.dtype).to(torch.float32)
    return (x.to(torch.float32) @ w.T).to(x.dtype)


def _lib():
    lib = _build.load("qmatmul")
    if not getattr(lib, "_argtypes_set", False):
        lib.qmatmul_gemv.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
                                     + [ctypes.c_void_p])
        lib.qmatmul_gemm_f32.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                                         + [ctypes.c_void_p])
        for fn in (lib.qmatmul_gemv, lib.qmatmul_gemm_f32):
            fn.restype = ctypes.c_int
        lib._argtypes_set = True
    return lib


def _lib_gemv_tc():
    lib = _build.load("qgemv_sm90")
    if not getattr(lib, "_argtypes_set", False):
        lib.qmatmul_gemv_tc.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                                        + [ctypes.c_void_p])
        lib.qmatmul_gemv_tc.restype = ctypes.c_int
        lib._argtypes_set = True
    return lib


def _lib_sm90():
    lib = _build.load("qgemm_sm90")
    if not getattr(lib, "_argtypes_set", False):
        lib.qgemm_sm90.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        lib.qgemm_sm90.restype = ctypes.c_int
        lib._argtypes_set = True
    return lib


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check_operands(x, packed, scales, codebook, bits, block_size):
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"qmatmul kernel takes f32 or bf16 activations, got {x.dtype}")
    for name, t, dt in (("packed", packed, torch.int32), ("scales", scales, torch.bfloat16),
                        ("codebook", codebook, torch.float32)):
        if t.dtype != dt:
            raise TypeError(f"qmatmul kernel: {name} must be {dt}, got {t.dtype}")
    for name, t in (("x", x), ("packed", packed), ("scales", scales), ("codebook", codebook)):
        if t.device != x.device:
            raise ValueError(f"qmatmul kernel: {name} on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"qmatmul kernel: {name} must be contiguous")
    if not 3 <= bits <= 8:
        raise ValueError(f"qmatmul kernel takes 3 to 8 bits, got {bits}")
    M, K = x.shape
    N, n_words = packed.shape
    if K != n_words * (32 // bits) or K % block_size or scales.shape != (N, K // block_size):
        raise ValueError(f"qmatmul kernel needs K-aligned operands (kernels/ops.qmatmul "
                         f"pads): x {tuple(x.shape)}, packed {tuple(packed.shape)}, "
                         f"scales {tuple(scales.shape)}, bits {bits}, block {block_size}")
    if codebook.shape != (2**bits,):
        raise ValueError(f"qmatmul kernel: codebook must have {2**bits} entries")
    if x.data_ptr() % 16:
        raise ValueError("qmatmul kernel: x must start on a 16-byte boundary")


def _stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


def qmatmul_gemv_tc(x, packed, scales, codebook, *, bits, block_size):
    """Launch the tensor-core GEMV (M <= GEMV_MAX_M rows, the operands
    ``gemv_route`` sends to "tc") on CUDA tensors."""
    _check_operands(x, packed, scales, codebook, bits, block_size)
    if gemv_route(x.dtype, bits, block_size) != "tc":
        raise ValueError(f"qmatmul_gemv_tc takes bf16 x at {TC_GEMV_BITS} bits with whole "
                         f"words per scale block, got {x.dtype}, {bits} bits, B {block_size}")
    M, K = x.shape
    N, n_words = packed.shape
    y = torch.empty((M, N), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        status = _lib_gemv_tc().qmatmul_gemv_tc(
            x.data_ptr(), packed.data_ptr(), scales.data_ptr(), codebook.data_ptr(),
            y.data_ptr(), M, N, K, n_words, bits, block_size, _stream(x))
    _build.check(status, "qmatmul_gemv_tc")
    qmatmul_gemv_tc.launches += 1
    return y


qmatmul_gemv_tc.launches = 0


def qmatmul_gemv_simt(x, packed, scales, codebook, *, bits, block_size):
    """Launch the CUDA-core GEMV (M <= GEMV_MAX_M rows, f32 or bf16 x) on
    CUDA tensors."""
    _check_operands(x, packed, scales, codebook, bits, block_size)
    M, K = x.shape
    N, n_words = packed.shape
    y = torch.empty((M, N), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        status = _lib().qmatmul_gemv(
            x.data_ptr(), packed.data_ptr(), scales.data_ptr(), codebook.data_ptr(),
            y.data_ptr(), M, N, K, n_words, bits, block_size,
            int(x.dtype == torch.bfloat16), _stream(x))
    _build.check(status, "qmatmul_gemv")
    qmatmul_gemv_simt.launches += 1
    return y


qmatmul_gemv_simt.launches = 0


def qmatmul_gemv(x, packed, scales, codebook, *, bits, block_size):
    """Launch the GEMV that ``gemv_route`` picks for the operands (M <=
    GEMV_MAX_M rows) on CUDA tensors; counts every launch of either."""
    tc = gemv_route(x.dtype, bits, block_size) == "tc"
    launch = qmatmul_gemv_tc if tc else qmatmul_gemv_simt
    y = launch(x, packed, scales, codebook, bits=bits, block_size=block_size)
    qmatmul_gemv.launches += 1
    return y


qmatmul_gemv.launches = 0


def qmatmul_gemm(x, packed, scales, codebook, *, bits, block_size):
    """Launch the tiled kernel on CUDA tensors: bf16 x on the tensor cores
    (``qgemm_sm90.cu``, split over K where ``split_k`` says), f32 x on the
    CUDA cores (``qmatmul.cu``)."""
    _check_operands(x, packed, scales, codebook, bits, block_size)
    M, K = x.shape
    N, n_words = packed.shape
    y = torch.empty((M, N), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        if x.dtype == torch.bfloat16:
            split = split_k(M, N, K, bits, _sm_count(x.device.index or 0))
            shape = split_workspace_shape(M, N, split)
            ws = (torch.empty(shape, dtype=torch.float32, device=x.device)
                  if shape else None)
            xt = torch.empty(x_tiles_shape(M, K, bits), dtype=torch.bfloat16, device=x.device)
            status = _lib_sm90().qgemm_sm90(
                x.data_ptr(), packed.data_ptr(), scales.data_ptr(), codebook.data_ptr(),
                y.data_ptr(), xt.data_ptr(), ws.data_ptr() if ws is not None else None,
                M, N, K, n_words, bits, block_size, split, _stream(x))
            entry = "qgemm_sm90"
        else:
            status = _lib().qmatmul_gemm_f32(
                x.data_ptr(), packed.data_ptr(), scales.data_ptr(), codebook.data_ptr(),
                y.data_ptr(), M, N, K, n_words, bits, block_size, _stream(x))
            entry = "qmatmul_gemm_f32"
    _build.check(status, entry)
    qmatmul_gemm.launches += 1
    qmatmul_gemm.simt_launches += entry == "qmatmul_gemm_f32"
    return y


qmatmul_gemm.launches = 0
#: the launches of the f32 CUDA-core GEMM (``qgemm_simt``) among them
qmatmul_gemm.simt_launches = 0


def qmatmul_cuda(x, packed, scales, codebook, *, bits, block_size):
    """The kernel for x's row count: GEMV for few rows, tiled otherwise."""
    launch = qmatmul_gemv if x.shape[0] <= GEMV_MAX_M else qmatmul_gemm
    return launch(x, packed, scales, codebook, bits=bits, block_size=block_size)


def qmatmul(x, packed, scales, codebook, *, bits: int, block_size: int) -> torch.Tensor:
    """K-aligned fused dequant-matmul: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors."""
    if x.device.type == "cuda":
        return qmatmul_cuda(x, packed, scales, codebook, bits=bits, block_size=block_size)
    if x.device.type == "cpu":
        return qmatmul_plain(x, packed, scales, codebook, bits=bits, block_size=block_size)
    raise ValueError(f"qmatmul runs on cuda or cpu tensors, not {x.device}")
