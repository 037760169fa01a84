"""Fused k-bit dequantize + matmul — port of ``repro/kernels/qmatmul.py``.

Replaces the TPU kernel ``qmatmul_pallas`` (src/repro/kernels/qmatmul.py:97)
with hand-written CUDA for Hopper, ``csrc/qmatmul.cu``:

  x       [M, K]        activations, f32 or bf16
  packed  [N, K//cpw]   int32 view of the uint32 words, cpw = 32 // bits
  scales  [N, K//B]     bf16 per-(column, K-block) absmax constants
  codebook[2**bits]     f32 sorted codebook
  y       [M, N]        f32 sums, written in x's dtype

The weight is rounded to x's dtype before the f32 product
(``qmatmul.py:80-85``), so this equals dequantize-then-matmul up to f32
summation order.  Every data type decodes through its codebook; for int the
table equals the TPU kernel's arithmetic ``clip(c-h, -h, h)/h`` bit for bit.

What bounds it on the card, and what the design does about it (the source
says more): at decode (M <= 8) the packed weight bytes, so a GEMV whose
blocks split each group of columns' K among their warps streams each packed
word from device memory once and decodes it with a shared-memory table
read; at prefill the 2*M*N*K
operations, so bf16 activations go to a kernel that dequantizes weight
tiles to bf16 in shared memory and multiplies them on the tensor cores
(wmma), and f32 activations to a tiled CUDA-core kernel.

``qmatmul`` takes the plain PyTorch version, ``qmatmul_plain``, only for
CPU tensors; for CUDA tensors it launches a kernel or raises.  Each launch
function counts its launches in a plain int, ``<function>.launches``.
Callers pad K first (``kernels/ops.qmatmul``).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core import packing
from repro_torch.kernels import _build

#: rows up to which the GEMV kernel runs (one pass over the packed weight)
GEMV_MAX_M = 8


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
        for fn in (lib.qmatmul_gemv, lib.qmatmul_gemm):
            fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib._argtypes_set = True
    return lib


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
    if bits not in (3, 4, 5, 6, 8):
        raise ValueError(f"qmatmul kernel takes 3, 4, 5, 6 or 8 bits, got {bits}")
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


def _launch(entry: str, x, packed, scales, codebook, bits, block_size):
    _check_operands(x, packed, scales, codebook, bits, block_size)
    M, K = x.shape
    N, n_words = packed.shape
    y = torch.empty((M, N), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        status = getattr(_lib(), entry)(
            x.data_ptr(), packed.data_ptr(), scales.data_ptr(), codebook.data_ptr(),
            y.data_ptr(), M, N, K, n_words, bits, block_size,
            int(x.dtype == torch.bfloat16), stream)
    _build.check(status, entry)
    return y


def qmatmul_gemv(x, packed, scales, codebook, *, bits, block_size):
    """Launch the GEMV kernel (M <= GEMV_MAX_M rows) on CUDA tensors."""
    y = _launch("qmatmul_gemv", x, packed, scales, codebook, bits, block_size)
    qmatmul_gemv.launches += 1
    return y


qmatmul_gemv.launches = 0


def qmatmul_gemm(x, packed, scales, codebook, *, bits, block_size):
    """Launch the tiled kernel on CUDA tensors."""
    y = _launch("qmatmul_gemm", x, packed, scales, codebook, bits, block_size)
    qmatmul_gemm.launches += 1
    return y


qmatmul_gemm.launches = 0


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
