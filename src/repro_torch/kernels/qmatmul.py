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
say more): at decode (M <= 8) the packed weight bytes.  ``gemv_route``
picks the GEMV from the operands.  bf16 x at 3 to 8 bits whose scale
blocks hold whole groups of 4 codes (whole words at 4 bits; the whole
serving path) goes to ``csrc/qgemv_sm90.cu``, which multiplies on the
tensor cores (``mma.sync`` in bf16, the packed words as the lanes' A
fragments).  The rest, f32 x and blocks that split a group, goes to the
GEMV of ``csrc/qmatmul.cu``, also on the tensor cores: ``mma.sync`` in
TF32, f32 operands split into two TF32 parts and three products summed
(3xTF32, about f32's precision), the codebook's parts in a shared-memory
table, and with f32 x and blocks of whole groups the scale taken out of
each group's sum.  Both GEMVs' blocks split each group of columns' K among
their warps, so every packed word is read from device memory once.  At
prefill the 2*M*N*K operations bound it, so bf16 activations go to
``csrc/qgemm_sm90.cu``: 256 (or 128) x 128 output tiles on Hopper's
``wgmma``, x copied as pre-laid-out tile images by the copy engine and the
packed words by ``cp.async`` into a ring of stages, the weight dequantized
into shared memory while the tensor cores multiply the previous K step.
The wrapper allocates the tile images (``x_tiles_shape``) and, where a
grid has fewer tiles than SMs and K is split across blocks (``split_k``),
the f32 partial sums that a second, fixed-order pass adds.  f32
activations go to a tiled CUDA-core kernel in ``csrc/qmatmul.cu`` (128 x
64 tiles, a cp.async double buffer, split over K by ``simt_split`` where a
1024-row call would not fill the SMs, and a fixed-order second pass).

A mixture-of-experts decode multiplies each expert's capacity buffer (at
most GEMV_MAX_M rows) by that expert's matrix: ``qmatmul_experts`` sends a
layer's stacked experts to one expert-batched launch of the tensor-core
GEMV (``qmatmul_gemv_experts``, a grid dimension over experts, a device row
count an expert, experts without rows not read), each expert's rows
bit-identical to ``qmatmul_gemv_tc`` on it alone; its plain version is
``qmatmul_plain`` an expert (``qmatmul_experts_plain``).

``qmatmul`` takes the plain PyTorch version, ``qmatmul_plain``, only for
CPU tensors; for CUDA tensors it launches a kernel or raises.  Each launch
function counts its launches in a plain int, ``<function>.launches``.
Every launcher takes the packed rows as the model stores them: K a whole
number of scale blocks (``kernels/ops.pad_for_kernel`` pads x to it) and
ceil(K / cpw) words a row, the last word's spare codes multiplying zero x.
Both GEMVs and the f32 GEMM read them so; the prefill GEMM, whose word
copies need rows of whole 16-byte pieces, pads K first (``pad_k``: a copy
of the weight at 3, 5 and 6 bits, cheaper at prefill than copying stored
rows a word at a time, PERF.md).
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.core import packing
from repro_torch.kernels import _build
from repro_torch.utils import cost

#: rows up to which the GEMV kernel runs (one pass over the packed weight)
GEMV_MAX_M = 8
#: bit widths of the tensor-core GEMV (csrc/qgemv_sm90.cu): its k16 steps
#: take each lane's codes 4 at a time, from one word (8 codes at 4 bits, 4
#: at 7 and 8) or across two (10, 6 and 5 at 3, 5 and 6 bits)
TC_GEMV_BITS = (3, 4, 5, 6, 7, 8)
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


def split_k(N: int, K: int, bits: int, sms: int = H100_SMS) -> int:
    """How many blocks share each output tile's K steps in the tensor-core
    kernel.  The split depends on N, K and the bit width alone, never on the
    rows M: a row's sums then take the same order however many rows share
    the call, so a chunked prefill's rows equal the plain prefill's bit for
    bit.  Counting the columns' tiles of one row tile: a weight with at
    least ``sms`` of them is not split.  Otherwise the split is the smallest
    divisor of the K steps that brings the block count to ``sms``, among
    those leaving each block >= MIN_SPLIT_STEPS steps; if none does, the
    largest of those."""
    tiles = -(-N // TILE_N)
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


#: the f32 CUDA-core GEMM (qmatmul.cu qgemm_simt): its output tile, its
#: codes per K step by bit width (SimtCfg<BITS>::BK: whole uint4s of words,
#: at least 32 codes), the blocks an SM holds (SG_MIN_BLOCKS), and the row
#: count whose tiles its split fills the SMs with (the paper sweep's
#: perplexity batch)
SIMT_TILE_M, SIMT_TILE_N = 128, 64
SIMT_K_STEP = {3: 40, 4: 32, 5: 48, 6: 40, 7: 32, 8: 32}
SIMT_BLOCKS_PER_SM = 3
SIMT_SPLIT_ROWS = 1024


def simt_split(N: int, K: int, bits: int, sms: int = H100_SMS) -> int:
    """How many blocks share each output tile's K steps in the f32 GEMM.  A
    function of N, K and the bit width, never of M, so a row's sums take
    the same order whatever rows share the call: the tiles a
    SIMT_SPLIT_ROWS-row call has, times the split, reach SIMT_BLOCKS_PER_SM
    blocks an SM where the K steps allow, with at least MIN_SPLIT_STEPS
    steps a split."""
    tiles = -(-N // SIMT_TILE_N) * (SIMT_SPLIT_ROWS // SIMT_TILE_M)
    steps = -(-K // SIMT_K_STEP[bits])
    target = SIMT_BLOCKS_PER_SM * sms
    if tiles >= target:
        return 1
    return max(1, min(steps // MIN_SPLIT_STEPS, -(-target // tiles)))


def tc_gemv_block_ok(bits: int, block_size: int) -> bool:
    """Do these scale blocks suit the tensor-core GEMV?  Each group of 4
    codes it decodes takes one scale: at 3, 5 and 6 bits B % 4 == 0; at 4,
    7 and 8 bits, whose kernel scales a word at a time, B % cpw == 0."""
    cpw = packing.codes_per_word(bits)
    return block_size % (cpw if cpw % 4 == 0 else 4) == 0


def gemv_route(x_dtype, bits: int, block_size: int) -> str:
    """The GEMV for these operands: "tc" (csrc/qgemv_sm90.cu) for bf16 x at
    3 to 8 bits whose scale blocks ``tc_gemv_block_ok`` takes, else "simt"
    (csrc/qmatmul.cu's GEMV, TF32 on the tensor cores)."""
    tc = (x_dtype == torch.bfloat16 and bits in TC_GEMV_BITS
          and tc_gemv_block_ok(bits, block_size))
    return "tc" if tc else "simt"


def _pad_cols(t: torch.Tensor, cols: int) -> torch.Tensor:
    """Zero-pad a 2-D tensor's last dim up to ``cols``; no copy when it fits."""
    return t if t.shape[1] == cols else torch.nn.functional.pad(t, (0, cols - t.shape[1]))


def pad_k(x, packed, scales, unit: int, *, bits: int, block_size: int):
    """The operands with K zero-padded to a multiple of ``unit`` (a multiple
    of B): x [M, K] and rows as stored in, (x, packed, scales) out, the rows
    still as stored for the new K.  Zero words decode against zero scales
    and multiply zero x, so the padding adds nothing to a sum.  No copy
    where K is such a multiple already; else a copy of the weight."""
    Kp = -(-x.shape[1] // unit) * unit
    return (_pad_cols(x, Kp), _pad_cols(packed, -(-Kp // (32 // bits))).contiguous(),
            _pad_cols(scales, Kp // block_size).contiguous())


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
        lib.qmatmul_gemm_f32.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
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


def _lib_gemv_experts():
    lib = _lib_gemv_tc()
    if not getattr(lib, "_experts_argtypes_set", False):
        lib.qmatmul_gemv_tc_experts.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int]
                                                + [ctypes.c_longlong] + [ctypes.c_int] * 6
                                                + [ctypes.c_void_p])
        lib.qmatmul_gemv_tc_experts.restype = ctypes.c_int
        lib._experts_argtypes_set = True
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
    if n_words != -(-K // (32 // bits)) or K % block_size or scales.shape != (N, K // block_size):
        raise ValueError(f"qmatmul kernel needs rows as stored, K whole scale blocks "
                         f"(kernels/ops.pad_for_kernel pads x): x {tuple(x.shape)}, "
                         f"packed {tuple(packed.shape)}, "
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
                         f"groups of 4 codes (at 4 bits words) per scale block, got {x.dtype}, "
                         f"{bits} bits, B {block_size}")
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
    """Launch the GEMV of ``csrc/qmatmul.cu`` (M <= GEMV_MAX_M rows, f32 or
    bf16 x; the operands ``gemv_route`` sends to "simt") on CUDA tensors,
    the rows as stored."""
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


def qmatmul_experts_plain(x, packed, scales, codebook, counts, *, bits: int,
                          block_size: int) -> torch.Tensor:
    """The plain version of the expert-batched GEMV: ``qmatmul_plain`` on
    each expert's rows.  x [E, M, K], packed [E, N, n_words], scales [E, N,
    K // B], codebook [E, 2**bits] -> y [E, M, N]; every row is computed (the
    kernel writes only rows below ``counts``; the others are no result of
    either)."""
    del counts
    return torch.stack([qmatmul_plain(x[e], packed[e], scales[e], codebook[e], bits=bits,
                                      block_size=block_size) for e in range(x.shape[0])])


def qmatmul_gemv_experts(x, packed, scales, codebook, counts, *, bits, block_size):
    """Launch the expert-batched tensor-core GEMV on CUDA tensors: x [E, M,
    K] bf16 (M <= GEMV_MAX_M rows an expert, each expert's rows contiguous,
    experts at any stride of whole 16 bytes), packed [E, N, n_words],
    scales [E, N, K // B], codebook [E, 2**bits] and counts [E] int32, the
    rows an expert holds, read on the card (a captured step's routing
    writes them).  Returns y [E, M, N]: expert e's rows below counts[e] are
    its product, bit-identical to ``qmatmul_gemv_tc`` on its operands alone;
    its other rows are not written.  One launch, whatever E."""
    E, M, K = x.shape
    if counts.dtype != torch.int32 or tuple(counts.shape) != (E,) \
            or counts.device != x.device or not counts.is_contiguous():
        raise ValueError(f"qmatmul_gemv_experts: counts must be int32 [{E}] on {x.device}, "
                         f"got {counts.dtype} {tuple(counts.shape)} on {counts.device}")
    if packed.ndim != 3 or packed.shape[0] != E or scales.ndim != 3 or scales.shape[0] != E \
            or codebook.shape != (E, 2**bits):
        raise ValueError(f"qmatmul_gemv_experts: operands of {E} experts: packed "
                         f"{tuple(packed.shape)}, scales {tuple(scales.shape)}, codebook "
                         f"{tuple(codebook.shape)}")
    if x.stride(2) != 1 or x.stride(1) != K or x.stride(0) % 8:
        raise ValueError(f"qmatmul_gemv_experts: x's rows must be contiguous and its experts "
                         f"16 bytes apart, got strides {x.stride()}")
    # the checks of one expert's launch on expert 0 (the kernel takes the
    # others at its strides)
    _check_operands(x[0], packed[0], scales[0], codebook[0], bits, block_size)
    for name, t in (("packed", packed), ("scales", scales), ("codebook", codebook)):
        if not t.is_contiguous():
            raise ValueError(f"qmatmul_gemv_experts: {name} must be contiguous")
    if gemv_route(x.dtype, bits, block_size) != "tc" or not 1 <= M <= GEMV_MAX_M:
        raise ValueError(f"qmatmul_gemv_experts takes bf16 x of 1 to {GEMV_MAX_M} rows an "
                         f"expert at {TC_GEMV_BITS} bits with whole groups of 4 codes (at 4 "
                         f"bits words) per scale block, got {x.dtype}, M {M}, {bits} bits, "
                         f"B {block_size}")
    N, n_words = packed.shape[1:]
    y = torch.empty((E, M, N), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        status = _lib_gemv_experts().qmatmul_gemv_tc_experts(
            x.data_ptr(), packed.data_ptr(), scales.data_ptr(), codebook.data_ptr(),
            y.data_ptr(), counts.data_ptr(), E, x.stride(0), M, N, K, n_words, bits,
            block_size, _stream(x))
    _build.check(status, "qmatmul_gemv_tc_experts")
    qmatmul_gemv_experts.launches += 1
    return y


qmatmul_gemv_experts.launches = 0


def _experts_work(x, packed, scales, codebook, counts, *, bits, block_size) -> dict:
    """B1's charge for a layer's experts: every row of x [E, M, K] (the rows
    an expert holds are device values, which a cost does not read) and
    every expert's words and scales as stored."""
    E, M, K = x.shape
    dot = 2 * E * M * packed.shape[1] * K
    return dict(flops=dot, dot_flops=dot,
                hbm_bytes=cost.nbytes(packed) + cost.nbytes(scales) + cost.nbytes(codebook)
                + cost.nbytes(counts) + cost.nbytes(x) + E * M * packed.shape[1]
                * x.element_size())


@cost.unit(_experts_work)
def qmatmul_experts(x, packed, scales, codebook, counts, *, bits: int,
                    block_size: int) -> torch.Tensor:
    """A layer's experts on their rows (``qmatmul_gemv_experts``'s
    operands): the expert-batched GEMV for CUDA tensors, the plain version
    for CPU tensors."""
    if x.device.type == "cuda":
        return qmatmul_gemv_experts(x, packed, scales, codebook, counts, bits=bits,
                                    block_size=block_size)
    if x.device.type == "cpu":
        return qmatmul_experts_plain(x, packed, scales, codebook, counts, bits=bits,
                                     block_size=block_size)
    raise ValueError(f"qmatmul_experts runs on cuda or cpu tensors, not {x.device}")


def qmatmul_gemm(x, packed, scales, codebook, *, bits, block_size):
    """Launch the tiled kernel on CUDA tensors: bf16 x on the tensor cores
    (``qgemm_sm90.cu``, split over K where ``split_k`` says), K padded to
    whole words and to pieces of 8 (its x tiles) first; f32 x on the CUDA
    cores (``qmatmul.cu``, split over K where ``simt_split`` says), rows as
    stored."""
    _check_operands(x, packed, scales, codebook, bits, block_size)
    if x.dtype == torch.bfloat16:
        x, packed, scales = pad_k(x, packed, scales, math.lcm(32 // bits, block_size, 8),
                                  bits=bits, block_size=block_size)
    M, K = x.shape
    N, n_words = packed.shape
    y = torch.empty((M, N), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        if x.dtype == torch.bfloat16:
            split = split_k(N, K, bits, _sm_count(x.device.index or 0))
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
            split = simt_split(N, K, bits, _sm_count(x.device.index or 0))
            shape = split_workspace_shape(M, N, split)
            ws = (torch.empty(shape, dtype=torch.float32, device=x.device)
                  if shape else None)
            status = _lib().qmatmul_gemm_f32(
                x.data_ptr(), packed.data_ptr(), scales.data_ptr(), codebook.data_ptr(),
                y.data_ptr(), ws.data_ptr() if ws is not None else None,
                M, N, K, n_words, bits, block_size, split, _stream(x))
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
